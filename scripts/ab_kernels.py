#!/usr/bin/env python
"""A/B of SpMV engines on one GPU: the DIA kernel candidates against the
plain XLA DIA form, and the general engines against each other, at the
proxies' published sizes (utils/synth.py).

  python scripts/ab_kernels.py                      # DIA and general cells
  python scripts/ab_kernels.py --only dia --rounds 5 --json out.json

DIA cells (cavity10_like, raefsky1_like, cube_coup_like) x {float32, bf16
slab, float64}:
  DIA_ROWS            the plain form the registry serves (formats/dia.py:
                      one static slice of the padded x per diagonal, which
                      XLA fuses into one pass over the slab)
  PL_loop_b*_w*_s*    a Pallas kernel compiled through Triton: one program
                      per block of b output rows, a fori_loop over an int32
                      offsets array, w warps, s pipeline stages
  PL_unroll_b*_w*_s*  the same with the offsets baked in and the diagonal
                      loop unrolled
  PL_RESID_b*         the loop kernel over the dense-offset core plus the
                      scattered fringe as per-row (column, value) slots
                      gathered in the same program (raefsky1_like only)
  CSR_ROWS_BINNED     the general engine, the other plain side of the hybrid
The earlier two-slice form (x viewed as (S, 128) rows, each diagonal the
concatenation of two row-shifted slices) is not kept; it ran about 3x
slower than DIA_ROWS on cube_coup_like.

General cells (delaunay_n12_like, fem_3d_thermal2_like, thermal2_like,
caida_like, webbase_like) x {float32, float64}: CSR_ROWS, ELL_ROWS_T (where
ELL fits its size cap) and CSR_ROWS_BINNED.

Each variant is timed two ways:
  call   host clock around block_until_ready, median of --calls calls after
         warm-up: what a caller of one product waits for, fixed per-call
         cost included
  chain  per product inside one compiled fori_loop (8 chained products per
         step), by the slope between two chain lengths: the fixed per-call
         cost cancels; each product carries a sum over y and a scaling of x
         (the chain's data dependence), the same in every variant of a cell
A round times every variant of a cell once, in turns, in an order rotated
from round to round; --rounds rounds run in this one process. Printed per
variant: the median over rounds and the range [min, max] of the rounds.
GB/s: the operands' bytes (slab or index/value arrays, x and y) over each
of the two times. Every result is checked against the oracle first.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import triton as plt  # noqa: E402

from spmv_openmp_cuda_tpu.config import Config  # noqa: E402
from spmv_openmp_cuda_tpu.formats.dia import DiaFillError, prepare_dia  # noqa: E402
from spmv_openmp_cuda_tpu.formats.matrix import CSRMatrix  # noqa: E402
from spmv_openmp_cuda_tpu.utils.pallas_env import interpret  # noqa: E402

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f64": jnp.float64}
DIA_CELLS = {
    "cavity10_like": ("DIA_ROWS", "PL_unroll_b128_w8_s3", "PL_loop_b128_w4_s2"),
    "raefsky1_like": ("DIA_ROWS", "CSR_ROWS_BINNED", "PL_unroll_b128_w8_s3",
                      "PL_unroll_b256_w8_s3", "PL_loop_b128_w4_s2",
                      "PL_RESID_b128"),
    "cube_coup_like": ("DIA_ROWS", "PL_unroll_b512_w8_s3",
                       "PL_unroll_b512_w4_s3", "PL_unroll_b1024_w8_s3",
                       "PL_loop_b1024_w4_s2"),
}
GENERAL_CELLS = ("delaunay_n12_like", "fem_3d_thermal2_like", "thermal2_like",
                 "caida_like", "webbase_like")
GENERAL_MODES = ("CSR_ROWS", "ELL_ROWS_T", "CSR_ROWS_BINNED")
CHAIN_K = 8


# ---------------------------------------------------------------------------
# the DIA kernel candidates
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "offs", "rcols", "rvals"],
    meta_fields=["offsets", "shape", "pad_lo", "x_len", "block", "unroll",
                 "num_warps", "num_stages"],
)
@dataclasses.dataclass
class KernelDIA:
    """Operands of dia_kernel_spmv: the diagonal-major slab with its rows
    padded to a block multiple, its offsets (static, and as an int32 array
    for the loop form) and the optional residual slots (K, m_pad). Offsets
    and residual columns index the padded x, whose origin is pad_lo; empty
    residual slots hold value 0 at a valid column."""

    data: jax.Array  # (D, m_pad)
    offs: jax.Array  # (D,) int32, pad_lo added
    rcols: jax.Array | None
    rvals: jax.Array | None
    offsets: tuple  # static offsets, pad_lo added
    shape: tuple
    pad_lo: int
    x_len: int  # length of the padded x
    block: int
    unroll: bool
    num_warps: int
    num_stages: int


def split_offsets(csr: CSRMatrix, min_occ_frac: float = 0.12) -> np.ndarray:
    """Keep mask per nnz for the DIA+residual hybrid: offsets occupied on at
    least min_occ_frac of the rows form the DIA core, the rest the fringe."""
    rows = csr.row_ids().astype(np.int64)
    _, inv, cnt = np.unique(csr.indices - rows, return_inverse=True,
                            return_counts=True)
    return (cnt >= max(min_occ_frac * csr.shape[0], 2))[inv]


def prepare_kernel(csr: CSRMatrix, dtype, block: int, unroll: bool = True,
                   num_warps: int = 4, num_stages: int = 2,
                   resid: bool = False) -> KernelDIA:
    m, n = csr.shape
    if resid:
        keep = split_offsets(csr)
        rows_all = csr.row_ids().astype(np.int64)
        core = CSRMatrix(
            (m, n),
            np.r_[0, np.cumsum(np.bincount(rows_all[keep], minlength=m))],
            csr.indices[keep], csr.data[keep])
        mat = prepare_dia(core, dtype=dtype)
    else:
        mat = prepare_dia(csr, dtype=dtype)
    m_pad = -(-mat.m_pad // block) * block
    data = jnp.pad(mat.data, ((0, 0), (0, m_pad - mat.m_pad)))
    lo = mat.pad_lo
    x_len = lo + m_pad + mat.pad_hi
    rcols = rvals = None
    if resid:
        rows_r = rows_all[~keep]
        per_row = np.bincount(rows_r, minlength=m)
        k = max(int(per_row.max(initial=0)), 1)
        slot = np.arange(rows_r.shape[0]) - np.r_[0, np.cumsum(per_row)][rows_r]
        cols_r = csr.indices[~keep].astype(np.int64)
        rc = np.full((k, m_pad), lo, dtype=np.int32)
        rv = np.zeros((k, m_pad))
        rc[slot, rows_r] = cols_r + lo
        rv[slot, rows_r] = csr.data[~keep]
        rcols, rvals = jnp.asarray(rc), jnp.asarray(rv, dtype=dtype)
        x_len = max(x_len, lo + int(cols_r.max(initial=0)) + 1)
    offsets = tuple(o + lo for o in mat.offsets)
    return KernelDIA(
        data=data, offs=jnp.asarray(offsets, jnp.int32), rcols=rcols,
        rvals=rvals, offsets=offsets, shape=(m, n), pad_lo=lo, x_len=x_len,
        block=block, unroll=unroll, num_warps=num_warps,
        num_stages=num_stages)


def _kernel(ops: KernelDIA, acc_t):
    block, n_diag = ops.block, len(ops.offsets)
    n_resid = 0 if ops.rcols is None else ops.rcols.shape[0]

    def kernel(data_ref, offs_ref, xp_ref, *rest):
        if n_resid:
            rcols_ref, rvals_ref, o_ref = rest
        else:
            (o_ref,) = rest
        row0 = pl.program_id(0) * block

        def diag(d, off, acc):
            a = data_ref[d, pl.ds(row0, block)].astype(acc_t)
            return acc + a * xp_ref[pl.ds(row0 + off, block)]

        acc = jnp.zeros((block,), acc_t)
        if ops.unroll:
            for d, off in enumerate(ops.offsets):
                acc = diag(d, off, acc)
        else:
            acc = jax.lax.fori_loop(
                0, n_diag, lambda d, acc: diag(d, offs_ref[d], acc), acc)
        if n_resid:

            def one(j, acc):
                c = rcols_ref[j, pl.ds(row0, block)]
                v = rvals_ref[j, pl.ds(row0, block)].astype(acc_t)
                return acc + v * xp_ref[c]

            acc = jax.lax.fori_loop(0, n_resid, one, acc)
        o_ref[...] = acc

    return kernel


def _whole(a) -> pl.BlockSpec:
    """Every program sees the whole array (it slices its own rows)."""
    return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)


def dia_kernel_spmv(ops: KernelDIA, x: jax.Array) -> jax.Array:
    """y = A @ x in one Pallas kernel (Triton on the GPU; the Pallas
    interpreter on the CPU, utils/pallas_env.py). bf16 slabs accumulate in
    float32."""
    acc_t = jnp.promote_types(ops.data.dtype, jnp.float32)
    m_pad = ops.data.shape[1]
    xc = x.astype(acc_t)[: ops.x_len - ops.pad_lo]
    xp = jnp.pad(xc, (ops.pad_lo, ops.x_len - ops.pad_lo - xc.shape[0]))
    args = [ops.data, ops.offs, xp]
    if ops.rcols is not None:
        args += [ops.rcols, ops.rvals]
    out = pl.pallas_call(
        _kernel(ops, acc_t),
        out_shape=jax.ShapeDtypeStruct((m_pad,), acc_t),
        grid=(m_pad // ops.block,),
        in_specs=[_whole(a) for a in args],
        out_specs=pl.BlockSpec((ops.block,), lambda i: (i,)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=ops.num_warps,
                                           num_stages=ops.num_stages),
        interpret=interpret(),
        name="dia_spmv",
    )(*args)
    return out[: ops.shape[0]]


def parse_variant(name: str) -> dict:
    """'PL_unroll_b512_w8_s3' -> prepare_kernel's keywords."""
    parts = name.split("_")
    kw = {"resid": parts[1] == "RESID", "unroll": parts[1] == "unroll"}
    for p in parts[2:]:
        key = {"b": "block", "w": "num_warps", "s": "num_stages"}[p[0]]
        kw[key] = int(p[1:])
    return kw


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def call_seconds(fn, x, calls: int) -> float:
    jax.block_until_ready(fn(x))
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def make_chain(run, ops):
    """steps x CHAIN_K chained products in one compiled loop; each x
    depends on the last y, so no product can be hoisted or dropped. The
    operands are an argument: closed over, they would become constants of
    the executable, which XLA may fold (a bf16 slab widened to f32 at
    compile time)."""

    @jax.jit
    def chain(ops, x, steps):
        def body(_, xv):
            for _ in range(CHAIN_K):
                y = run(ops, xv)
                xv = xv * (1.0 + jnp.sum(y) * 1e-30)
            return xv

        return jax.lax.fori_loop(0, steps, body, x)

    return functools.partial(chain, ops)


def chain_seconds(chain, x, target_s: float = 0.2) -> float:
    """Per product, from the slope between 1 and N steps (N sized so the
    long chain runs about target_s)."""

    def timed(steps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x, jnp.int32(steps)))
        return time.perf_counter() - t0

    timed(1)
    t1 = timed(1)
    n = max(8, min(200_000, int(target_s / max(t1 / CHAIN_K, 1e-7) / CHAIN_K)))
    tn = timed(n)
    return max(tn - t1, 0.0) / ((n - 1) * CHAIN_K)


def operand_bytes(ops, x, y) -> int:
    leaves = jax.tree_util.tree_leaves(ops)
    return sum(a.nbytes for a in leaves + [x, y] if hasattr(a, "nbytes"))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def build(variant: str, csr, dtype_key: str):
    """(run, ops, x dtype) for one variant, or None where it cannot hold
    this matrix (DIA fill, ELL size cap) or this dtype (bf16 on a general
    engine)."""
    from spmv_openmp_cuda_tpu.formats.convert import (
        EllSizeError, coo_to_ell, csr_to_coo,
    )
    from spmv_openmp_cuda_tpu.ops import registry

    dtype = DTYPES[dtype_key]
    acc = jnp.promote_types(dtype, jnp.float32)
    try:
        if variant.startswith("PL_"):
            ops = prepare_kernel(csr, dtype, **parse_variant(variant))
            return dia_kernel_spmv, ops, acc
        if dtype_key == "bf16" and variant == "DIA_ROWS":
            variant = "DIA_BF16"
        elif dtype_key == "bf16":
            return None
        spec = registry.get(variant)
        cfg = Config(dtype="float64" if dtype_key == "f64" else "float32")
        ell = None
        if spec.fmt == "ell":
            ell = coo_to_ell(csr_to_coo(csr), max_entries=cfg.ell_max_entries)
        return spec.run, spec.prepare(csr, ell, cfg), acc
    except (DiaFillError, EllSizeError) as e:
        print(f"    {variant}: skipped ({e})", flush=True)
        return None


def run_cell(name: str, csr, dtype_key: str, variants, rounds: int,
             calls: int, card: str) -> list:
    from spmv_openmp_cuda_tpu.utils.compare import relative_error

    tol = {"f32": 1e-5, "bf16": 8e-3, "f64": 1e-12}[dtype_key]
    x_host = np.random.default_rng(1).uniform(-1.0, 1.0, csr.shape[1])
    built = {}
    for v in variants:
        b = build(v, csr, dtype_key)
        if b is None:
            continue
        run, ops, acc = b
        x = jax.device_put(jnp.asarray(x_host, acc))
        fn = jax.jit(run)
        y = fn(ops, x)
        err = relative_error(y, csr, x_host)
        if not err <= tol:
            raise AssertionError(f"{name} {dtype_key} {v}: rel_err {err:.2e}")
        built[v] = (functools.partial(fn, ops), make_chain(run, ops), x,
                    operand_bytes(ops, x, y), err)
    times = {v: ([], []) for v in built}
    order = list(built)
    for r in range(rounds):
        for v in order[r % len(order):] + order[: r % len(order)]:
            fn, chain, x, _, _ = built[v]
            times[v][0].append(call_seconds(fn, x, calls))
            times[v][1].append(chain_seconds(chain, x))
    rows = []
    for v, (tc, tk) in times.items():
        nbytes, err = built[v][3], built[v][4]
        row = {
            "preset": name, "dtype": dtype_key, "variant": v, "card": card,
            "call_us": statistics.median(tc) * 1e6,
            "call_us_range": [min(tc) * 1e6, max(tc) * 1e6],
            "chain_us": statistics.median(tk) * 1e6,
            "chain_us_range": [min(tk) * 1e6, max(tk) * 1e6],
            "call_gbs": nbytes / statistics.median(tc) / 1e9,
            "chain_gbs": nbytes / max(statistics.median(tk), 1e-12) / 1e9,
            "rel_err": err, "rounds": rounds, "calls": calls,
        }
        rows.append(row)
    for row in sorted(rows, key=lambda r: r["chain_us"]):
        print(f"  {name:22s} {dtype_key:4s} {row['variant']:24s} "
              f"call {row['call_us']:8.1f} us "
              f"[{row['call_us_range'][0]:.1f}, {row['call_us_range'][1]:.1f}] "
              f"{row['call_gbs']:7.1f} GB/s | chain {row['chain_us']:8.2f} us "
              f"[{row['chain_us_range'][0]:.2f}, {row['chain_us_range'][1]:.2f}] "
              f"{row['chain_gbs']:7.1f} GB/s | rel_err {row['rel_err']:.2e}",
              flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["dia", "general"], default=None)
    ap.add_argument("--presets", nargs="*", default=None,
                    help="limit to these presets")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--calls", type=int, default=25)
    ap.add_argument("--json", default=None, help="write all rows here")
    args = ap.parse_args(argv)

    from spmv_openmp_cuda_tpu import coo_to_csr
    from spmv_openmp_cuda_tpu.utils import synth
    from spmv_openmp_cuda_tpu.utils.compile_cache import enable_compile_cache
    from spmv_openmp_cuda_tpu.utils.envinfo import gpu_name_power

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"ab_kernels: needs a GPU, JAX's first device is {dev.platform}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    card = (gpu_name_power() or "unknown card").splitlines()[0]
    print(f"device {dev.device_kind}, jax {jax.__version__}; card: {card}",
          flush=True)
    cells = []
    if args.only in (None, "dia"):
        cells += [(p, d, DIA_CELLS[p]) for p in DIA_CELLS
                  for d in ("f32", "bf16", "f64")]
    if args.only in (None, "general"):
        cells += [(p, d, GENERAL_MODES) for p in GENERAL_CELLS
                  for d in ("f32", "f64")]
    if args.presets:
        cells = [c for c in cells if c[0] in args.presets]
    rows, csrs = [], {}
    for preset, dtype_key, variants in cells:
        if preset not in csrs:
            t0 = time.perf_counter()
            csrs.clear()  # one proxy in memory at a time
            csrs[preset] = coo_to_csr(synth.preset(preset))
            print(f"[{preset}] {csrs[preset].shape} nnz={csrs[preset].nnz} "
                  f"({time.perf_counter() - t0:.0f} s to generate)", flush=True)
        # x64 only for the float64 cells: under it the float32 engines'
        # index arrays would widen to int64
        jax.config.update("jax_enable_x64", dtype_key == "f64")
        rows += run_cell(preset, csrs[preset], dtype_key, variants,
                         args.rounds, args.calls, card)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
