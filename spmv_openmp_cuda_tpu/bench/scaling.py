"""Mesh-scaling harness: SpMV time and scaling efficiency vs device count.

The BASELINE north star asks for measured scaling efficiency at 1 chip /
1 host / >= 2 hosts. This tool runs the sharded engines over meshes of
increasing size and reports per-device-count chain-slope times and
efficiency = t(1) / (d * t(d)). On GPUs the numbers are the scaling
measurement; on virtual CPU devices they validate the sharded paths
end-to-end and exercise the identical collectives (ppermute halo / psum),
with timings labelled as virtual.

Usage:
  python -m spmv_openmp_cuda_tpu.bench.scaling --preset thermal2_like \
      --devices 1 2 4 8 --path dia_halo
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _slope(chain_fn, carry, lo=5, hi=55):
    import jax
    import jax.numpy as jnp

    ts = {}
    for steps in (lo, hi):
        ch = chain_fn(steps)
        r = ch(carry)
        _ = float(jnp.sum(jax.tree_util.tree_leaves(r)[0]))
        best = float("inf")
        for _rep in range(3):
            t0 = time.perf_counter()
            r = ch(carry)
            _ = float(jnp.sum(jax.tree_util.tree_leaves(r)[0]))
            best = min(best, time.perf_counter() - t0)
        ts[steps] = best
    return max((ts[hi] - ts[lo]) / (hi - lo), 1e-9)


def run_scaling(preset: str, device_counts: List[int], path: str):
    import jax
    import jax.numpy as jnp

    import spmv_openmp_cuda_tpu as S
    from ..formats.dia import prepare_dia
    from ..io.vectors import fill_rnd_vector
    from ..ops.oracle import serial_csr_spmv
    from ..parallel import mesh as M
    from ..parallel import sharded as sh
    from ..utils import synth
    from ..utils.compare import vectors_diff

    coo = synth.preset(preset)
    csr = S.coo_to_csr(coo)
    x = fill_rnd_vector(csr.shape[1], seed=1)
    oracle = serial_csr_spmv(csr, x)
    virtual = jax.default_backend() == "cpu"
    log(
        f"#scaling preset={preset} nnz={csr.nnz} path={path} "
        f"backend={jax.default_backend()}{' (virtual devices)' if virtual else ''}"
    )
    rows = []
    t1 = None
    for d in device_counts:
        if d > len(jax.devices()):
            log(f"d={d}: only {len(jax.devices())} devices, skipping")
            continue
        mesh = M.make_mesh((d, 1), devices=jax.devices()[:d])
        if path == "ell_rows":
            op = sh.prepare_row_sharded_ell(S.coo_to_ell(coo), mesh)
            spmv = sh.make_ell_rows_sharded(mesh)
            xs = jnp.asarray(x, dtype=jnp.float32)
        elif path == "csr_psum":
            mesh_c = M.make_mesh((1, d), devices=jax.devices()[:d])
            op = sh.prepare_col_sharded_csr(csr, mesh_c)
            xs = sh.pad_x_for_col_sharding(np.asarray(x), op, mesh_c, jnp.float32)
            spmv = sh.make_csr_cols_psum(mesh_c, csr.shape[0])
        elif path == "dia_halo":
            mat = prepare_dia(csr, max_fill_ratio=1e9)
            op = sh.prepare_dia_sharded(mat, mesh)
            xs = sh.pad_x_for_dia_sharded(np.asarray(x), op, mesh, jnp.float32)
            spmv = sh.make_dia_sharded(mesh, op)
        elif path == "ell_ring":
            op = sh.prepare_ring_ell(csr, mesh)
            xs = sh.pad_x_for_ring(np.asarray(x), op, mesh, jnp.float32)
            spmv = sh.make_ell_ring(mesh, op)
        else:
            raise SystemExit(f"unknown path {path}")

        def mk(steps, spmv=spmv, op=op):
            @jax.jit
            def chain(xv):
                def body(i, xv):
                    yv = spmv(op, xv)
                    return xv * (1.0 + jnp.sum(yv) * 1e-30)

                return jax.lax.fori_loop(0, steps, body, xv, unroll=False)

            return chain

        y = np.asarray(spmv(op, xs), np.float64).reshape(-1)[: csr.shape[0]]
        rep = vectors_diff(y, oracle)
        t = _slope(mk, xs)
        if t1 is None:
            t1 = t
        eff = t1 / (d * t)
        rows.append((d, t, eff, rep.ok))
        log(
            f"d={d}: {t*1e6:10.1f} us/step  efficiency={eff:5.2f}  "
            f"check={'OK' if rep.ok else 'FAIL'}"
        )
    print(
        "preset,path,virtual,devices,time_s,efficiency,ok"
        + "".join(
            f"\n{preset},{path},{int(virtual)},{d},{t:.3e},{e:.3f},{int(ok)}"
            for d, t, e, ok in rows
        )
    )
    return 0 if all(ok for *_, ok in rows) else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="fem_3d_thermal2_like")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument(
        "--path",
        choices=["dia_halo", "ell_ring", "ell_rows", "csr_psum"],
        default="dia_halo",
    )
    ap.add_argument(
        "--virtual",
        type=int,
        default=0,
        metavar="N",
        help="force the CPU backend with N virtual devices (checks the "
        "mesh without GPUs; times are then labelled virtual)",
    )
    args = ap.parse_args(argv)
    if args.virtual:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.virtual)
    return run_scaling(args.preset, args.devices, args.path)


if __name__ == "__main__":
    sys.exit(main())
