"""XLA-lowered SpMV kernels (gather + segment reductions).

These are the XLA re-designs of the reference's OpenMP strategy
matrix (SURVEY.md section 2.4): instead of IRP-driven scalar loops
(reference src/SpMV_CSR_OMP.c) or padded-slab row loops (src/SpMV_ELL_OMP.c),
CSR becomes a fused dense-vector gather + sorted segment-sum, and ELL becomes
a lane-vectorized gather-multiply-reduce over (M, W) slabs. XLA fuses the
gather, multiply, and reduction into bandwidth-bound loops over HBM.

The 2D tile variants reproduce the reference's partial-sum-then-reduce
semantics (spmvTilesCSR SpMV_CSR_OMP.c:101-162, spmvTilesELL
SpMV_ELL_OMP.c:110-174): partials are materialized per (row, column-range)
and reduced at the end — the structural analog of contraction-axis sharding.
"""
from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.matrix import DeviceCSR, DeviceELL, fair_splits


def _row_reduce(prods: jax.Array, simd: bool) -> jax.Array:
    """Reduce (M, W) products along W.

    simd=True: vectorized tree reduction (SIMD_ROWS_REDUCTION analog).
    simd=False: strict left-to-right accumulation via scan over width chunks
    (the scalar-order reduction the reference gets without `omp simd`).
    """
    if simd:
        return jnp.sum(prods, axis=1)
    w = prods.shape[1]
    chunk = 128 if w % 128 == 0 else 1
    steps = w // chunk

    def body(acc, xs):
        return acc + (xs.sum(axis=1) if chunk > 1 else xs[:, 0]), None

    xs = jnp.moveaxis(prods.reshape(prods.shape[0], steps, chunk), 1, 0)
    acc, _ = jax.lax.scan(body, jnp.zeros(prods.shape[0], prods.dtype), xs)
    return acc


# ---------------------------------------------------------------------------
# CSR kernels
# ---------------------------------------------------------------------------


def csr_rows(mat: DeviceCSR, x: jax.Array) -> jax.Array:
    """Row-parallel CSR SpMV (spmvRowsBasicCSR analog, SpMV_CSR_OMP.c:34-63).

    gather x at cols, multiply, sorted segment-sum by row id. Padded tail
    nnz carry value 0 so any clip/drop semantics of out-of-range segment ids
    (row_id == M) cannot perturb the result.
    """
    m = mat.shape[0]
    prods = mat.data * x[mat.cols].astype(mat.data.dtype)
    return jax.ops.segment_sum(
        prods, mat.row_ids, num_segments=m, indices_are_sorted=True
    )


def csr_rows_groups(
    mat: DeviceCSR,
    x: jax.Array,
    starts: jax.Array,
    rows_per_block: int,
    max_ext: int,
) -> jax.Array:
    """Fair row-block CSR SpMV (spmvRowsBlocksCSR analog, SpMV_CSR_OMP.c:65-99).

    A genuinely blocked schedule (NOT an alias of csr_rows): block b owns
    rows [b*rows_per_block, (b+1)*rows_per_block); `starts` holds each
    block's nnz offset (host-derived from indptr) and max_ext the largest
    block extent. Blocks run under lax.map — a sequential per-block loop,
    the compiled analog of the reference's static OMP schedule where each
    thread walks its own row block. Each block dynamic-slices the nnz
    stream at its offset with the static max extent, masks the overhang,
    and does a local sorted segment-sum into its row range.
    """
    m = mat.shape[0]
    rpb = rows_per_block
    b_count = starts.shape[0] - 1
    prods = mat.data * x[mat.cols].astype(mat.data.dtype)
    # pad so every dynamic slice of max_ext is in range; padded row ids map
    # to the overflow slot rpb and are dropped
    prods_pad = jnp.pad(prods, (0, max_ext))
    rows_pad = jnp.pad(
        mat.row_ids, (0, max_ext), constant_values=np.iinfo(np.int32).max
    )
    arange_ext = jnp.arange(max_ext)

    def block(b):
        s = starts[b]
        ext = starts[b + 1] - s
        p = jax.lax.dynamic_slice(prods_pad, (s,), (max_ext,))
        r = jax.lax.dynamic_slice(rows_pad, (s,), (max_ext,))
        local = jnp.clip(r - b * rpb, 0, rpb).astype(jnp.int32)
        p = jnp.where(arange_ext < ext, p, 0)
        return jax.ops.segment_sum(
            p, local, num_segments=rpb + 1, indices_are_sorted=True
        )

    partials = jax.lax.map(block, jnp.arange(b_count, dtype=jnp.int32))
    return partials[:, :rpb].reshape(-1)[:m]


def _bucketize_cols(cols: jax.Array, n: int, grid_cols: int) -> jax.Array:
    """Map column index -> uniform column-range id (fair remainder split)."""
    splits = jnp.asarray(fair_splits(n, grid_cols)[1:-1], dtype=cols.dtype)
    return jnp.searchsorted(splits, cols, side="right").astype(jnp.int32)


def csr_tiles(mat: DeviceCSR, x: jax.Array, grid_cols: int = 8) -> jax.Array:
    """2D-tiled CSR SpMV with partial sums (spmvTilesCSR analog,
    SpMV_CSR_OMP.c:101-162).

    Each nnz lands in partial tile (row, column-range); partials form an
    (M, grid_cols) buffer summed at the end — the same
    partial-products-then-reduce semantics as the reference's tilesOutTmp,
    expressed as a segment-sum over (row * grid_cols + bucket) ids.
    """
    m, n = mat.shape
    bucket = _bucketize_cols(mat.cols, n, grid_cols)
    seg = mat.row_ids.astype(jnp.int32) * grid_cols + bucket
    prods = mat.data * x[mat.cols].astype(mat.data.dtype)
    partials = jax.ops.segment_sum(
        prods, seg, num_segments=m * grid_cols, indices_are_sorted=True
    )
    return partials.reshape(m, grid_cols).sum(axis=1)


def csr_tiles_allocd(parts: Sequence[DeviceCSR], x: jax.Array) -> jax.Array:
    """2D-tiled CSR over separately-allocated column partitions
    (spmvTilesAllocdCSR analog, SpMV_CSR_OMP.c:165-226).

    Each partition is an independent DeviceCSR (partition.cols_partitioning);
    partial results are combined by summation. Columns stay global, so each
    part gathers from the full x (the sharded variant gathers from its x
    shard instead).
    """
    m = parts[0].shape[0]
    out = jnp.zeros(m, dtype=parts[0].data.dtype)
    for p in parts:
        out = out + csr_rows(p, x)
    return out


# ---------------------------------------------------------------------------
# ELL kernels
# ---------------------------------------------------------------------------


def _ell_mask(mat: DeviceELL) -> jax.Array:
    """(M_pad, W_pad) validity mask from row lengths (ROWLENS analog)."""
    w = mat.data.shape[1]
    k = jax.lax.broadcasted_iota(jnp.int32, mat.data.shape, 1)
    return k < mat.row_lens[:, None]


def ell_rows(
    mat: DeviceELL, x: jax.Array, row_lens: bool = True, simd: bool = True
) -> jax.Array:
    """Row-parallel ELL SpMV over padded slabs (spmvRowsBasicELL analog,
    SpMV_ELL_OMP.c:33-67).

    Lane-vectorized gather of x at the (M, W) column slab, multiply by the
    value slab, reduce along W. row_lens=True masks padding explicitly (the
    ROWLENS early-exit analog; here the mask guards against padding
    artifacts when slabs hold non-zero filler).
    """
    m = mat.shape[0]
    xg = x[mat.cols].astype(mat.data.dtype)
    prods = mat.data * xg
    if row_lens:
        prods = jnp.where(_ell_mask(mat), prods, 0)
    return _row_reduce(prods, simd)[:m]


def ell_rows_groups(
    mat: DeviceELL, x: jax.Array, grid_rows: int = 8, row_lens: bool = True
) -> jax.Array:
    """Fair row-block ELL SpMV (spmvRowsBlocksELL analog,
    SpMV_ELL_OMP.c:69-108).

    A genuinely blocked schedule (NOT an alias of ell_rows): the padded slab
    is cut into grid_rows row blocks and reduced block-by-block under
    lax.scan — the sequential per-block loop of the reference's static OMP
    schedule, compiled as a real loop instead of one fused reduction.
    """
    m = mat.shape[0]
    xg = x[mat.cols].astype(mat.data.dtype)
    prods = mat.data * xg
    if row_lens:
        prods = jnp.where(_ell_mask(mat), prods, 0)
    m_pad, w = prods.shape
    b = max(min(grid_rows, m_pad), 1)
    rpb = -(-m_pad // b)
    prods = jnp.pad(prods, ((0, b * rpb - m_pad), (0, 0)))

    def step(carry, blk):
        return carry, blk.sum(axis=1)

    _, ys = jax.lax.scan(step, jnp.zeros((), prods.dtype), prods.reshape(b, rpb, w))
    return ys.reshape(-1)[:m]


def ell_tiles(
    mat: DeviceELL,
    x: jax.Array,
    grid_cols: int = 8,
    row_lens: bool = True,
    simd: bool = True,
) -> jax.Array:
    """2D-tiled ELL SpMV splitting the *padded width* (spmvTilesELL analog,
    SpMV_ELL_OMP.c:110-174): each width-range produces a partial column of an
    (M, grid_cols) buffer, reduced at the end."""
    m = mat.shape[0]
    w = mat.data.shape[1]
    xg = x[mat.cols].astype(mat.data.dtype)
    prods = mat.data * xg
    if row_lens:
        prods = jnp.where(_ell_mask(mat), prods, 0)
    splits = fair_splits(w, grid_cols)
    partials = []
    for j in range(grid_cols):
        seg = prods[:, int(splits[j]) : int(splits[j + 1])]
        partials.append(_row_reduce(seg, simd) if seg.shape[1] else jnp.zeros(prods.shape[0], prods.dtype))
    return jnp.stack(partials, axis=1).sum(axis=1)[:m]


def ell_rows_transposed(
    mat: DeviceELL, x: jax.Array, simd: bool = True
) -> jax.Array:
    """ELL SpMV on the transposed (W, M) slab layout (cudaSpMVRowsELL analog,
    SpMV_CUDA.cu:79-96, which pre-transposes for coalescing —
    sparseUtils.c:145-185).

    The transposed layout puts consecutive output rows next to each other,
    so each step of the reduction over W reads values, columns and x
    gathers for adjacent rows together — the memory-coalescing analog.
    Requires mat.transposed=True.
    """
    assert mat.transposed, "ell_rows_transposed needs a transposed DeviceELL"
    m = mat.shape[0]
    xg = x[mat.cols].astype(mat.data.dtype)  # (W_pad, M_pad)
    prods = mat.data * xg
    if simd:
        return jnp.sum(prods, axis=0)[:m]
    acc, _ = jax.lax.scan(
        lambda a, p: (a + p, None),
        jnp.zeros(prods.shape[1], prods.dtype),
        prods,
    )
    return acc[:m]
