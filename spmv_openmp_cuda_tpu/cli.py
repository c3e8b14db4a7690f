"""CLI driver.

Analog of the reference's src/main.cu:66-283:
  usage: spmv <matrixFile.mtx[.gz|.xz|.bz2|.zip]> <vectorFile | RNDVECT> [COMPUTE_MODE]
parses the matrix into the mode's format, loads or generates the dense vector,
runs the selected kernel, dumps the output vector (raw + text) under TMPDIR,
and prints computeMode / elapsed / elapsedInternal.

Config comes from env (GRID_ROWS, GRID_COLS, SPMV_DTYPE, ... — the reference's
getConfig env tier, utils.c:279-302).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np

from .config import Config, RNDVECTORSIZE
from .formats.convert import EllSizeError, coo_to_csr, coo_to_ell
from .io.mmio import read_coo
from .io.vectors import (
    fill_rnd_vector,
    read_vector,
    write_vector_raw,
    write_vector_str,
)
from .ops import registry


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spmv_openmp_cuda_tpu",
        description="JAX SpMV (y = A @ x) on MatrixMarket matrices",
    )
    p.add_argument(
        "matrix",
        nargs="?",
        help=".mtx file, optionally gz/xz/bz2/zip compressed",
    )
    p.add_argument(
        "vector",
        nargs="?",
        help="dense-vector file (text or raw float64) or the literal RNDVECT",
    )
    p.add_argument(
        "compute_mode",
        nargs="?",
        default="CSR_ROWS",
        help=f"AUTO (structure-driven selection) or one of: "
        f"{', '.join(registry.names())}",
    )
    p.add_argument(
        "--dtype",
        choices=["float32", "float64"],
        default=None,
        help="compute dtype (overrides SPMV_DTYPE; float64 runs every "
        "engine natively, bf16-storage modes remap to their float64 twin)",
    )
    p.add_argument("--list-modes", action="store_true", help="list kernels and exit")
    p.add_argument(
        "--env",
        action="store_true",
        help="print runtime environment info (backend, devices, env "
        "overrides — the reference's OMP ICV dump, ompGetICV.c:23-73) and "
        "exit",
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="capture a jax.profiler trace (TensorBoard format) of the "
        "timed kernel chain into DIR (two-level timing analog of "
        "main.cu:229-242 plus a device trace the reference lacks)",
    )
    p.add_argument("--no-dump", action="store_true", help="skip output vector dumps")
    p.add_argument("--check", action="store_true", help="verify against serial oracle")
    p.add_argument(
        "--testtests",
        action="store_true",
        help="TESTTESTS mode (reference SpMV_test.cu:227-236): diff the "
        "serial oracle against the dense-GEMV oracle on this matrix and "
        "exit (no kernel run)",
    )
    p.add_argument(
        "--save-prepared",
        metavar="PATH",
        help="serialize the prepared device format to PATH (.npz) after the "
        "run (checkpoint: skips re-preparation next time)",
    )
    p.add_argument(
        "--load-prepared",
        metavar="PATH",
        help="load a previously saved prepared format instead of preparing "
        "(the matrix file is still read for shape/oracle checks)",
    )
    return p


def _adapt_loaded(operands, spec):
    """Validate a deserialized prepared format for the selected mode.

    Returns (operands, error): a kind/mode mismatch is a friendly error
    instead of a trace-time crash."""
    from .formats.binned import BinnedCSR
    from .formats.dia import DeviceDIA
    from .formats.matrix import DeviceCSR, DeviceELL

    expected = {
        "DIA_ROWS": DeviceDIA,
        "DIA_BF16": DeviceDIA,
        "CSR_ROWS": DeviceCSR,
        "CSR_ROWS_BINNED": BinnedCSR,
        "ELL_ROWS": DeviceELL,
        "ELL_ROWS_NOSIMD": DeviceELL,
        "ELL_ROWS_NORL": DeviceELL,
        "ELL_ROWS_T": DeviceELL,
    }.get(spec.name)
    if expected is None:
        return None, (
            f"mode {spec.name} cannot run from a serialized prepared format"
        )
    if not isinstance(operands, expected):
        return None, (
            f"loaded prepared format {type(operands).__name__} does not "
            f"match mode {spec.name}"
        )
    if isinstance(operands, DeviceELL):
        want_t = spec.name == "ELL_ROWS_T"
        if operands.transposed != want_t:
            return None, (
                f"loaded DeviceELL transposed={operands.transposed} does not "
                f"match mode {spec.name}"
            )
    return operands, None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    if args.list_modes:
        for s in registry.all_kernels():
            print(f"{s.name:24s} [{s.impl}/{s.fmt}] {s.doc}")
        return 0
    if args.env:
        from .utils.envinfo import format_info

        print(format_info())
        return 0
    if not args.matrix or not args.vector:
        build_argparser().error("the following arguments are required: matrix, vector")

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = Config.from_env()
    if args.dtype:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, dtype=args.dtype)

    mode = args.compute_mode
    is_auto = mode.upper() == "AUTO"
    if not is_auto:
        # fail fast on a typo'd mode BEFORE paying the matrix parse
        try:
            registry.get(mode)
        except KeyError as e:
            print(f"ERROR: {e.args[0]}", file=sys.stderr)
            return 1

    t0 = time.perf_counter()
    coo = read_coo(args.matrix)
    csr = coo_to_csr(coo)
    if is_auto:
        # structure-driven selection and its fallback: AutoSpMV's own
        from .models.auto import AUTO_MODES, select_format

        fmt = select_format(csr)
        mode = AUTO_MODES[fmt]
        print(f"#auto: format={fmt} -> {mode}")
    spec = registry.get(mode)
    if cfg.dtype == "float64" and not spec.f64:
        # bf16-storage modes cannot hold double values: run the same
        # engine with a float64 slab
        new_mode = {"DIA_BF16": "DIA_ROWS"}[mode]
        print(
            f"#dtype: float64 unsupported by bf16 mode {mode}; "
            f"remapping to {new_mode}"
        )
        mode = new_mode
        spec = registry.get(mode)
    ell = None
    if spec.fmt == "ell" and not args.load_prepared:
        try:
            ell = coo_to_ell(coo, max_entries=cfg.ell_max_entries)
        except EllSizeError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
    parse_time = time.perf_counter() - t0
    m, n = csr.shape
    print(f"#matrix: {os.path.basename(args.matrix)} {m} {n} {csr.nnz} {csr.max_row_nz} (parse {parse_time:.3f}s)")

    if args.vector == "RNDVECT":
        x = fill_rnd_vector(n, seed=cfg.seed or None)
        if not args.no_dump:
            write_vector_raw(os.path.join(cfg.tmpdir, "rndVectorDumpRaw"), x)
            write_vector_str(os.path.join(cfg.tmpdir, "rndVectorDump"), x)
    else:
        x = read_vector(args.vector)
        if x.shape[0] != n:
            print(
                f"ERROR: vector size {x.shape[0]} != matrix cols {n}", file=sys.stderr
            )
            return 1

    if args.testtests:
        # TESTTESTS: validate the serial oracle against the dense-GEMV
        # oracle and exit (reference SpMV_test.cu:227-236)
        from .ops.oracle import oracle_vs_oracle

        rep = oracle_vs_oracle(csr, x)
        status = "OK" if rep.ok else "FAIL"
        print(f"#testtests: {status} maxAbsDiff={rep.max_abs_diff:.3e}")
        return 0 if rep.ok else 2

    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    if args.load_prepared:
        from .formats.serialize import load_prepared

        operands = load_prepared(args.load_prepared)
        operands, err = _adapt_loaded(operands, spec)
        if err:
            print(f"ERROR: {err}", file=sys.stderr)
            return 1
    elif is_auto:
        from .models.auto import prepare_format

        got, spec, operands = prepare_format(csr, fmt, cfg)
        if got != fmt:
            print(f"#auto: {mode} infeasible; falling back to {spec.name}")
    else:
        from .formats.dia import DiaFillError

        try:
            operands = spec.prepare(csr, ell, cfg)
        except DiaFillError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
    if args.save_prepared:
        from .formats.serialize import save_prepared

        try:
            save_prepared(args.save_prepared, operands)
            print(f"#prepared saved: {args.save_prepared}")
        except TypeError:
            print(
                f"#prepared not serializable for mode {spec.name}",
                file=sys.stderr,
            )
    from .utils.profiling import Timings, profiler_trace, wall_timer

    f = spec.jitted(operands)
    xj = jax.device_put(jnp.asarray(x, dtype=cfg.jnp_dtype))
    y = jax.block_until_ready(f(xj))  # includes compile
    elapsed = time.perf_counter() - t0
    # internal time by chain slope: the difference of two chain lengths
    # cancels the fixed per-call dispatch cost
    run = spec.run

    K = 8  # spmv's per loop iteration (amortizes loop overhead)

    @jax.jit
    def chain(xv, iters):
        def body(i, xv):
            for _ in range(K):
                yv = run(operands, xv)
                xv = xv * (1.0 + jnp.sum(yv) * 1e-30)
            return xv

        # iters is traced: one compilation serves both chain lengths
        return jax.lax.fori_loop(0, iters, body, xv, unroll=False)

    def timed_chain(steps):
        it = -(-steps // K)
        t = Timings()
        _ = float(jnp.sum(chain(xj, jnp.int32(it))))
        with wall_timer(t):
            _ = float(jnp.sum(chain(xj, jnp.int32(it))))
        return t.wall, it * K

    with profiler_trace(args.profile):
        t_lo, lo_n = timed_chain(2)
        t_hi, hi_n = timed_chain(lo_n + max(cfg.avg_times_iteration, 16))
        if t_hi - t_lo < 0.2:  # step signal drowned in dispatch noise: escalate
            slope1 = max((t_hi - t_lo) / (hi_n - lo_n), 1e-7)
            # t_lo/lo_n upper-bounds the true per-step time, so this caps the
            # escalated chain at ~3 s of device time even when noise makes the
            # measured slope collapse to the 1e-7 floor
            cap = max(int(3.0 / max(t_lo / lo_n, 1e-7)), lo_n)
            t_hi, hi_n = timed_chain(lo_n + min(int(0.5 / slope1), cap, 500_000))
    if args.profile:
        print(f"#profile: jax.profiler trace written to {args.profile}")
    elapsed_internal = (t_hi - t_lo) / (hi_n - lo_n)
    if elapsed_internal <= 0:
        elapsed_internal = t_hi / hi_n  # noise-bound: conservative bound
    y_host = np.asarray(y, dtype=np.float64)[:m]

    if args.check:
        from .ops.oracle import serial_csr_spmv
        from .utils.compare import vectors_diff

        rep = vectors_diff(y_host, serial_csr_spmv(csr, x))
        status = "OK" if rep.ok else "FAIL"
        print(f"#check: {status} maxAbsDiff={rep.max_abs_diff:.3e}")
        if not rep.ok:
            return 2

    if not args.no_dump:
        write_vector_raw(os.path.join(cfg.tmpdir, "outVectorDumpRaw"), y_host)
        write_vector_str(os.path.join(cfg.tmpdir, "outVectorDump"), y_host)

    print(
        f"computeMode:{spec.name} elapsed:{elapsed:.9f} "
        f"elapsedInternal:{elapsed_internal:.9f} "
        f"GFLOPS:{2.0 * csr.nnz / elapsed_internal / 1e9:.4f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
