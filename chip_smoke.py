#!/usr/bin/env python
"""Smoke run of the SpMV main path on NVIDIA GPUs, at the proxies' published
sizes (utils/synth.py), each result checked against the NumPy oracle.

  python chip_smoke.py              # one GPU: phases 0-4
  python chip_smoke.py --devices 4  # four GPUs: the sharded paths only

Phases (the first failure exits non-zero and prints no result line):
  0. device: JAX's first device must be a GPU; prints the card.
  1. DIA engines at real widths (cube_coup_like, raefsky1_like): f32,
     bf16 slab and f64 compiled, memory analysis printed, vs the oracle.
  2. AutoSpMV on every proxy in f32 and f64: chosen format, per-call time,
     vs the oracle.
  3. the CLI in AUTO mode, f32 and f64, on a raefsky1_like .mtx.
  4. solvers: CG on an SPD band of 2^20 rows (f32 and f64), power
     iteration once.
  5. (--devices 4 only) row-sharded ELL, column psum and ELL ring on
     thermal2_like, DIA halo on cube_coup_like.

Tolerances are relative to max_i sum_j |a_ij x_j| with x of unit scale
(utils/compare.py:relative_error): 1e-5 for f32, 8e-3 for bf16 slabs,
1e-12 for f64, set by the summation order and the storage precision. f32
results must also pass the reference protocol (7e-4 absolute with
|x| < 3e-5), which alone would pass almost anything.

The last stdout line is {"ok": true, "device": {...}} on success.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = {"float32": 1e-5, "bfloat16": 8e-3, "float64": 1e-12}
AUTO_PRESETS = (
    "delaunay_n12_like", "raefsky1_like", "fem_3d_thermal2_like",
    "thermal2_like", "caida_like", "cavity10_like", "webbase_like",
    "cube_coup_like",
)


class SmokeFailure(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def x64(enabled: bool):
    """float64 phases switch x64 on; restore it after (it is global)."""
    import jax

    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enabled or before)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def per_call_seconds(fn, x, reps: int = 20) -> float:
    """Median host-clock time of fn(x) around block_until_ready."""
    import jax

    jax.block_until_ready(fn(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def unit_x(n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 1.0, n)


def check_result(y, csr, x, dtype: str, label: str) -> float:
    from spmv_openmp_cuda_tpu.utils.compare import relative_error

    y = np.asarray(y, dtype=np.float64)
    check(y.shape[0] >= csr.shape[0] and np.isfinite(y).all(),
          f"{label}: bad shape or non-finite output")
    err = relative_error(y, csr, x)
    check(err <= TOL[dtype], f"{label}: relative error {err:.3e} > {TOL[dtype]}")
    return err


def phase_device(want: int):
    """Phase 0: the GPU, its count and the card's name and power limit."""
    import jax

    from spmv_openmp_cuda_tpu.utils.envinfo import gpu_name_power

    devs = jax.devices()
    log(f"[0] platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    check(devs[0].platform == "gpu", "no GPU: JAX's first device is "
          f"{devs[0].platform}")
    check(len(devs) >= want, f"need {want} GPUs, JAX sees {len(devs)}")
    card = gpu_name_power()
    check(card is not None, "nvidia-smi gave no card name and power limit")
    return devs, card


def phase_dia(csrs: dict, card: str) -> None:
    """Phase 1: the DIA engines compiled at real widths, vs the oracle."""
    import jax
    import jax.numpy as jnp

    from spmv_openmp_cuda_tpu.config import Config
    from spmv_openmp_cuda_tpu.ops import registry

    for name, csr in csrs.items():
        x = unit_x(csr.shape[1])
        for mode, dtype in (("DIA_ROWS", "float32"), ("DIA_BF16", "bfloat16"),
                            ("DIA_ROWS", "float64")):
            with x64(dtype == "float64"):
                cfg = Config(dtype="float64" if dtype == "float64" else "float32")
                spec = registry.get(mode)
                ops = spec.prepare(csr, None, cfg)
                xj = jnp.asarray(x, cfg.jnp_dtype)
                fn = jax.jit(spec.run)
                compiled = fn.lower(ops, xj).compile()
                log(f"[1] {name} {mode} {dtype}: {compiled.memory_analysis()}")
                y = compiled(ops, xj)
                err = check_result(y, csr, x, dtype, f"{name} {mode} {dtype}")
                t = per_call_seconds(lambda v: compiled(ops, v), xj)
                log(f"[1] {name} {mode} {dtype}: rel_err {err:.2e}, "
                    f"{t * 1e6:.1f} us/call on {card}")


def phase_auto(csrs: dict, card: str) -> None:
    """Phase 2: AutoSpMV on every proxy, f32 and f64, vs the oracle."""
    import jax

    from spmv_openmp_cuda_tpu.config import Config
    from spmv_openmp_cuda_tpu.io.vectors import fill_rnd_vector
    from spmv_openmp_cuda_tpu.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu.ops.oracle import serial_csr_spmv
    from spmv_openmp_cuda_tpu.utils.compare import vectors_diff

    for name, csr in csrs.items():
        for dtype in ("float32", "float64"):
            with x64(dtype == "float64"):
                model = AutoSpMV.from_csr(csr, cfg=Config(dtype=dtype))
                x = unit_x(csr.shape[1])
                err = check_result(model(x), csr, x, dtype,
                                   f"{name} auto {dtype}")
                if dtype == "float32":
                    xr = fill_rnd_vector(csr.shape[1], seed=2)
                    rep = vectors_diff(np.asarray(model(xr), np.float64),
                                       serial_csr_spmv(csr, xr))
                    check(rep.ok, f"{name} auto f32: reference protocol {rep}")
                t = per_call_seconds(model, jax.device_put(
                    np.asarray(x, model.dtype)))
                log(f"[2] {name} {dtype}: format={model.format} "
                    f"mode={model.mode} rel_err {err:.2e}, "
                    f"{t * 1e6:.1f} us/call on {card}")


def phase_cli(coo, workdir: str) -> None:
    """Phase 3: the CLI in AUTO mode with --check, f32 and f64."""
    from spmv_openmp_cuda_tpu.cli import main as cli_main
    from spmv_openmp_cuda_tpu.io.mmio import write_mtx

    path = os.path.join(workdir, "raefsky1_like.mtx")
    write_mtx(path, coo)
    for dtype in ("float32", "float64"):
        out = io.StringIO()
        with x64(False), contextlib.redirect_stdout(out):
            rc = cli_main([path, "RNDVECT", "AUTO", "--check", "--no-dump",
                           "--dtype", dtype])
        text = out.getvalue()
        log("\n".join(f"[3] {dtype}: {line}" for line in text.splitlines()))
        check(rc == 0 and "#check: OK" in text, f"CLI AUTO {dtype}: rc {rc}")


def spd_band(m: int, half_bw: int, seed: int):
    """Symmetric, strictly diagonally dominant band with positive diagonal
    (hence SPD): the construction of tests/test_solvers.py, built sparse."""
    from spmv_openmp_cuda_tpu.formats.convert import sort_coo
    from spmv_openmp_cuda_tpu.formats.matrix import COOMatrix

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    rowsum = np.zeros(m)
    for off in range(1, half_bw + 1):
        v = rng.standard_normal(m - off) * 0.3
        i = np.arange(m - off)
        rows += [i, i + off]
        cols += [i + off, i]
        vals += [v, v]
        np.add.at(rowsum, i, np.abs(v))
        np.add.at(rowsum, i + off, np.abs(v))
    rows.append(np.arange(m))
    cols.append(np.arange(m))
    vals.append(rowsum + 1.0)
    return sort_coo(COOMatrix((m, m), np.concatenate(rows),
                              np.concatenate(cols), np.concatenate(vals)))


def phase_solvers(m: int, card: str) -> None:
    """Phase 4: CG through AutoSpMV (f32 to 1e-6, f64 to 1e-10; the residual
    recomputed on the host) and one power iteration."""
    from spmv_openmp_cuda_tpu.config import Config
    from spmv_openmp_cuda_tpu.formats.convert import coo_to_csr
    from spmv_openmp_cuda_tpu.formats.matrix import CSRMatrix
    from spmv_openmp_cuda_tpu.models.auto import AutoSpMV
    from spmv_openmp_cuda_tpu.models.solvers import (
        conjugate_gradient, power_iteration,
    )
    from spmv_openmp_cuda_tpu.ops.oracle import serial_csr_spmv

    csr = coo_to_csr(spd_band(m, 4, seed=3))
    b = serial_csr_spmv(csr, unit_x(m, seed=4))
    # the true residual of an f32 solve stalls near its rounding level;
    # 10x the recursive tolerance leaves room for that, not for a wrong x
    for dtype, tol, true_tol in (("float32", 1e-6, 1e-5),
                                 ("float64", 1e-10, 1e-9)):
        with x64(dtype == "float64"):
            model = AutoSpMV.from_csr(csr, cfg=Config(dtype=dtype))
            t0 = time.perf_counter()
            res = conjugate_gradient(model, b.astype(dtype), tol=tol,
                                     maxiter=1000)
            xs = np.asarray(res.x, np.float64)
            dt = time.perf_counter() - t0
            true = np.linalg.norm(b - serial_csr_spmv(csr, xs)) / np.linalg.norm(b)
            log(f"[4] CG {dtype} m={m} nnz={csr.nnz} format={model.format}: "
                f"{int(res.iters)} iters, relres {float(res.relres):.2e}, "
                f"host residual {true:.2e}, {dt:.3f} s incl. compile on {card}")
            check(float(res.relres) <= tol, f"CG {dtype} did not converge")
            check(true <= true_tol, f"CG {dtype}: host residual {true:.2e}")
    model = AutoSpMV.from_csr(csr)
    lam = float(power_iteration(model, m, iters=50, seed=1).eigenvalue)
    gersh = float(serial_csr_spmv(
        CSRMatrix(csr.shape, csr.indptr, csr.indices, np.abs(csr.data)),
        np.ones(m)).max())
    mean_diag = float(csr.data[csr.indices == csr.row_ids()].mean())
    log(f"[4] power iteration: lambda {lam:.6f} in [{mean_diag:.6f}, "
        f"{gersh:.6f}]")
    # SPD: the iterates' Rayleigh quotients only grow, from about the mean
    # diagonal (a random start), and never pass the Gershgorin bound
    check(np.isfinite(lam) and 0.99 * mean_diag <= lam <= gersh * (1 + 1e-4),
          f"power iteration eigenvalue {lam} outside its bounds")


def phase_sharded(csr_ell, csr_dia, devs, card: str) -> None:
    """Phase 5: the four sharded paths on the GPUs, vs the oracle."""
    import jax.numpy as jnp

    from spmv_openmp_cuda_tpu.formats.convert import coo_to_ell, csr_to_coo
    from spmv_openmp_cuda_tpu.formats.dia import prepare_dia
    from spmv_openmp_cuda_tpu.ops.oracle import serial_csr_spmv
    from spmv_openmp_cuda_tpu.parallel import mesh as M
    from spmv_openmp_cuda_tpu.parallel import sharded as sh
    from spmv_openmp_cuda_tpu.utils.compare import vectors_diff

    nd = len(devs)
    rows_mesh = M.make_mesh((nd, 1), devices=devs)
    cols_mesh = M.make_mesh((1, nd), devices=devs)
    x = unit_x(csr_ell.shape[1])
    runs = []
    op = sh.prepare_row_sharded_ell(coo_to_ell(csr_to_coo(csr_ell)), rows_mesh)
    runs.append(("row-sharded ELL", csr_ell, sh.make_ell_rows_sharded(rows_mesh),
                 op, jnp.asarray(x, jnp.float32), x))
    op = sh.prepare_col_sharded_csr(csr_ell, cols_mesh)
    runs.append(("column psum", csr_ell,
                 sh.make_csr_cols_psum(cols_mesh, csr_ell.shape[0]), op,
                 sh.pad_x_for_col_sharding(x, op, cols_mesh, jnp.float32), x))
    op = sh.prepare_ring_ell(csr_ell, rows_mesh)
    runs.append(("ELL ring", csr_ell, sh.make_ell_ring(rows_mesh, op), op,
                 sh.pad_x_for_ring(x, op, rows_mesh, jnp.float32), x))
    xd = unit_x(csr_dia.shape[1])
    op = sh.prepare_dia_sharded(prepare_dia(csr_dia), rows_mesh)
    runs.append(("DIA halo", csr_dia, sh.make_dia_sharded(rows_mesh, op), op,
                 sh.pad_x_for_dia_sharded(xd, op, rows_mesh, jnp.float32), xd))
    for label, csr, spmv, op, xs, xh in runs:
        y = np.asarray(spmv(op, xs), np.float64).reshape(-1)[: csr.shape[0]]
        err = check_result(y, csr, xh, "float32", label)
        xr = xh * 3e-5  # the reference protocol's input scale
        xrs = xs * 3e-5
        rep = vectors_diff(np.asarray(spmv(op, xrs), np.float64).reshape(-1)
                           [: csr.shape[0]], serial_csr_spmv(csr, xr))
        check(rep.ok, f"{label}: reference protocol {rep}")
        t = per_call_seconds(lambda v: spmv(op, v), xs)
        log(f"[5] {label} on {nd} GPUs: rel_err {err:.2e}, "
            f"{t * 1e6:.1f} us/call on {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=[1, 4], default=1,
                    help="4: run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)
    try:
        import jax  # noqa: F401

        import spmv_openmp_cuda_tpu as S
        from spmv_openmp_cuda_tpu.utils import synth
        from spmv_openmp_cuda_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}", file=sys.stderr)
        return 1
    try:
        enable_compile_cache()
        devs, card = phase_device(args.devices)
        t0 = time.perf_counter()

        def load(name):
            t = time.perf_counter()
            csr = S.coo_to_csr(synth.preset(name))
            log(f"    {name}: {csr.shape[0]} rows, {csr.nnz} nnz "
                f"({time.perf_counter() - t:.0f} s to generate)")
            return csr

        if args.devices == 4:
            phase_sharded(load("thermal2_like"), load("cube_coup_like"),
                          devs[:4], card)
        else:
            csrs = {name: load(name) for name in AUTO_PRESETS}
            phase_dia({k: csrs[k] for k in ("cube_coup_like", "raefsky1_like")},
                      card)
            phase_auto(csrs, card)
            with tempfile.TemporaryDirectory(dir=REPO) as workdir:
                phase_cli(synth.preset("raefsky1_like"), workdir)
            phase_solvers(1 << 20, card)
        log(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
