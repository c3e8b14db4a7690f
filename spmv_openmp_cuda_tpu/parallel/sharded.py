"""Multi-device sharded SpMV (shard_map + collectives over a Mesh).

Replacement for what the reference does with OMP shared memory and
single-GPU transfers (SURVEY.md section 5 "distributed communication
backend"): the row-block kernels become row-sharded data parallelism, the 2D
tile kernels become contraction-axis sharding with psum of partials, and the
dense-vector access becomes an explicit halo/ring exchange (ppermute)
overlapped with local tile compute — the pattern BASELINE.json's north star
prescribes. XLA hands the collectives to NCCL on GPUs.

Four designs:
- ell_rows_sharded: rows sharded, x replicated (DP analog; one all-gather of
  x amortized at input placement).
- csr_cols_psum: columns sharded, partial y psum'd (spmvTilesCSR/Allocd
  analog: the partial-sum reduction is a collective instead of a serial
  loop).
- ell_ring: rows AND x sharded; the x shard ring-rotates via ppermute while
  each step multiplies the matching local column stripe — nothing
  replicated, the multi-host scaling path. Comm/compute overlap is
  DEPENDENCY-LEVEL: each step's multiply consumes the pre-permute chunk, so
  the collective carries no data dependence on the multiply and XLA's
  latency-hiding scheduler may split it into async start/done around the
  compute (tests/test_sharded.py asserts the dependency structure; the
  actual async split is the GPU scheduler's decision, not observable on the
  CPU mesh).
- dia_sharded: the diagonal slab and x row-sharded, the shift reach moved
  by a one-step ppermute halo.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # JAX >= 0.6 public API
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs, **kw):
        return _shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **kw
        )
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map_old

    def shard_map(f, mesh, in_specs, out_specs, **kw):
        return _shard_map_old(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **kw
        )

from ..config import LANE, SUBLANE
from ..formats.matrix import CSRMatrix, ELLMatrix, _ceil_to
from .mesh import COLS, ROWS


# ---------------------------------------------------------------------------
# 1) Row-sharded ELL — the DP / row-block analog
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "cols", "row_lens"],
    meta_fields=["m", "nnz"],
)
@dataclasses.dataclass
class RowShardedELL:
    """Host-prepared operands for ell_rows_sharded."""

    data: jax.Array  # (M_pad, W) sharded P(rows, None)
    cols: jax.Array  # (M_pad, W) sharded P(rows, None)
    row_lens: jax.Array  # (M_pad,) sharded P(rows)
    m: int
    nnz: int


def prepare_row_sharded_ell(
    ell: ELLMatrix, mesh: Mesh, dtype=jnp.float32
) -> RowShardedELL:
    n_rows = mesh.shape[ROWS]
    m, _ = ell.shape
    w = max(_ceil_to(max(ell.max_row_nz, 1), LANE), LANE)
    m_pad = _ceil_to(max(m, 1), SUBLANE * n_rows)
    data = np.zeros((m_pad, w), dtype=np.float64)
    cols = np.zeros((m_pad, w), dtype=np.int32)
    rl = np.zeros(m_pad, dtype=np.int32)
    data[:m, : ell.max_row_nz] = ell.data
    cols[:m, : ell.max_row_nz] = ell.ja
    # without explicit row_lens, treat rows as full width: padded slots hold
    # value 0 so they cannot perturb sums (counting nonzeros would wrongly
    # truncate rows containing explicitly stored zeros)
    rl[:m] = ell.row_lens if ell.row_lens is not None else ell.max_row_nz
    sh2 = NamedSharding(mesh, P(ROWS, None))
    sh1 = NamedSharding(mesh, P(ROWS))
    return RowShardedELL(
        data=jax.device_put(jnp.asarray(data, dtype=dtype), sh2),
        cols=jax.device_put(jnp.asarray(cols), sh2),
        row_lens=jax.device_put(jnp.asarray(rl), sh1),
        m=m,
        nnz=ell.nnz,
    )


def make_ell_rows_sharded(mesh: Mesh):
    """y = A @ x with A row-sharded, x replicated, y row-sharded."""

    def local(data, cols, row_lens, x):
        prods = data * x[cols].astype(data.dtype)
        k = jax.lax.broadcasted_iota(jnp.int32, prods.shape, 1)
        prods = jnp.where(k < row_lens[:, None], prods, 0)
        return prods.sum(axis=1)

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(ROWS, None), P(ROWS, None), P(ROWS), P()),
        out_specs=P(ROWS),
    )

    @jax.jit
    def spmv(op: RowShardedELL, x):
        return f(op.data, op.cols, op.row_lens, x)

    return spmv


# ---------------------------------------------------------------------------
# 2) Column-sharded CSR with psum — the 2D-tiles partial-sum analog
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "local_cols", "row_ids"],
    meta_fields=["x_pad", "stripe_w", "m", "nnz"],
)
@dataclasses.dataclass
class ColShardedCSR:
    """Per-device column-stripe CSR parts, stacked on a leading device axis."""

    data: jax.Array  # (D, nnz_max) P(cols, None)
    local_cols: jax.Array  # (D, nnz_max) P(cols, None)
    row_ids: jax.Array  # (D, nnz_max) P(cols, None)
    x_pad: int  # padded total x length (D * stripe_w)
    stripe_w: int
    m: int
    nnz: int


def prepare_col_sharded_csr(
    csr: CSRMatrix, mesh: Mesh, dtype=jnp.float32
) -> ColShardedCSR:
    """Split columns into uniform stripes of width ceil(N/D) (column indices
    re-based per stripe so each device gathers from its local x shard)."""
    d = mesh.shape[COLS]
    m, n = csr.shape
    stripe_w = -(-n // d)
    bucket = np.minimum(csr.indices // stripe_w, d - 1).astype(np.int64)
    rids_all = csr.row_ids()
    counts = np.bincount(bucket, minlength=d)
    nnz_max = max(_ceil_to(max(int(counts.max(initial=1)), 1), LANE), LANE)
    data = np.zeros((d, nnz_max), dtype=np.float64)
    lcols = np.zeros((d, nnz_max), dtype=np.int32)
    rids = np.full((d, nnz_max), m, dtype=np.int32)
    for j in range(d):
        sel = bucket == j
        k = int(counts[j])
        data[j, :k] = csr.data[sel]
        lcols[j, :k] = (csr.indices[sel] - j * stripe_w).astype(np.int32)
        rids[j, :k] = rids_all[sel]
    sh = NamedSharding(mesh, P(COLS, None))
    return ColShardedCSR(
        data=jax.device_put(jnp.asarray(data, dtype=dtype), sh),
        local_cols=jax.device_put(jnp.asarray(lcols), sh),
        row_ids=jax.device_put(jnp.asarray(rids), sh),
        x_pad=d * stripe_w,
        stripe_w=stripe_w,
        m=m,
        nnz=csr.nnz,
    )


def make_csr_cols_psum(mesh: Mesh, m: int):
    """y = psum_j(A_stripe_j @ x_shard_j): contraction-axis sharding.

    Padding nnz carry value 0 and row_id == m, so the out-of-range segment id
    cannot perturb row sums regardless of clip/drop semantics.
    """

    def local(data, lcols, rids, x_shard):
        prods = data[0] * x_shard[lcols[0]].astype(data.dtype)
        part = jax.ops.segment_sum(
            prods, rids[0], num_segments=m, indices_are_sorted=True
        )
        return jax.lax.psum(part, COLS)

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(COLS, None), P(COLS, None), P(COLS, None), P(COLS)),
        out_specs=P(),
    )

    @jax.jit
    def spmv(op: ColShardedCSR, x_padded):
        return f(op.data, op.local_cols, op.row_ids, x_padded)

    return spmv


def pad_x_for_col_sharding(x: np.ndarray, op: ColShardedCSR, mesh: Mesh, dtype):
    xp = np.zeros(op.x_pad, dtype=np.float64)
    xp[: x.shape[0]] = x
    return jax.device_put(
        jnp.asarray(xp, dtype=dtype), NamedSharding(mesh, P(COLS))
    )


# ---------------------------------------------------------------------------
# 3) Ring-overlap ELL — rows AND x sharded, ppermute halo exchange
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "cols"],
    meta_fields=["m", "nnz", "d", "m_loc", "w_s", "chunk_w", "x_pad"],
)
@dataclasses.dataclass
class RingELL:
    """Each device: its row block's slab split into D column stripes
    (stripes axis leading), column indices re-based to stripe-local."""

    data: jax.Array  # (D*M_loc, D_stripes*W_s) P(rows, None) flattened below
    cols: jax.Array
    m: int
    nnz: int
    d: int
    m_loc: int
    w_s: int
    chunk_w: int
    x_pad: int


def prepare_ring_ell(csr: CSRMatrix, mesh: Mesh, dtype=jnp.float32) -> RingELL:
    """Build per-(row-block, column-stripe) ELL slabs from CSR.

    Stripe s of row block b is an (M_loc, W_s) slab where W_s is the global
    max per-row nnz within any single stripe (lane-aligned), so all devices
    and steps are shape-uniform — the static-shape requirement of the jitted
    ring.
    """
    d = mesh.shape[ROWS]
    m, n = csr.shape
    m_loc = _ceil_to(max(-(-m // d), 1), SUBLANE)
    chunk_w = -(-n // d)
    bucket = np.minimum(csr.indices // chunk_w, d - 1).astype(np.int64)
    rids = csr.row_ids()
    # per (row, stripe) counts -> W_s
    per_rs = np.zeros((m, d), dtype=np.int64)
    np.add.at(per_rs, (rids, bucket), 1)
    w_s = max(_ceil_to(max(int(per_rs.max(initial=1)), 1), LANE), LANE)
    data = np.zeros((d, m_loc, d, w_s), dtype=np.float64)  # (dev, row, stripe, k)
    cols = np.zeros((d, m_loc, d, w_s), dtype=np.int32)
    # slot of each nnz within its (row, stripe) group
    order = np.lexsort((csr.indices, bucket, rids))  # sorted by row, stripe, col
    r_s, b_s, c_s, v_s = rids[order], bucket[order], csr.indices[order], csr.data[order]
    group = r_s.astype(np.int64) * d + b_s
    # position within group
    start = np.zeros(m * d + 1, dtype=np.int64)
    np.cumsum(np.bincount(group, minlength=m * d), out=start[1:])
    slot = np.arange(group.shape[0]) - start[group]
    dev = r_s // m_loc
    row_l = r_s % m_loc
    data[dev, row_l, b_s, slot] = v_s
    cols[dev, row_l, b_s, slot] = (c_s - b_s * chunk_w).astype(np.int32)
    sh = NamedSharding(mesh, P(ROWS, None, None))
    return RingELL(
        data=jax.device_put(
            jnp.asarray(data.reshape(d * m_loc, d, w_s), dtype=dtype), sh
        ),
        cols=jax.device_put(jnp.asarray(cols.reshape(d * m_loc, d, w_s)), sh),
        m=m,
        nnz=csr.nnz,
        d=d,
        m_loc=m_loc,
        w_s=w_s,
        chunk_w=chunk_w,
        x_pad=d * chunk_w,
    )


def make_ell_ring(mesh: Mesh, op_meta: RingELL):
    """Fully-sharded SpMV: x shard ring-rotates over the rows axis while each
    step multiplies the matching local column stripe.

    Step s on device i: partial += stripe[(i - s) mod D] @ x_chunk, then
    ppermute the chunk to device (i+1) mod D. The multiply and the ppermute
    both read the carried chunk and neither depends on the other within a
    step (audited in tests/test_sharded.py), so an async-collective
    scheduler can overlap them; on hardware the split into
    collective-permute-start/done is XLA's scheduler's call.
    """
    d, m_loc, w_s = op_meta.d, op_meta.m_loc, op_meta.w_s
    perm = [(i, (i + 1) % d) for i in range(d)]

    def local(data, cols, x_chunk):
        my = jax.lax.axis_index(ROWS)

        def body(s, carry):
            acc, chunk = carry
            stripe = (my - s) % d
            dat = jax.lax.dynamic_index_in_dim(data, stripe, axis=1, keepdims=False)
            idx = jax.lax.dynamic_index_in_dim(cols, stripe, axis=1, keepdims=False)
            prods = dat * chunk[idx].astype(dat.dtype)
            acc = acc + prods.sum(axis=1)
            chunk = jax.lax.ppermute(chunk, ROWS, perm)
            return acc, chunk

        acc = jnp.zeros(data.shape[0], data.dtype)
        # mark the accumulator as device-varying so the carry types match
        # across ppermute steps (shard_map VMA typing)
        acc = jax.lax.pcast(acc, (ROWS,), to="varying")
        acc, _ = jax.lax.fori_loop(0, d, body, (acc, x_chunk))
        return acc

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(ROWS, None, None), P(ROWS, None, None), P(ROWS)),
        out_specs=P(ROWS),
    )

    @jax.jit
    def spmv(op: RingELL, x_padded):
        return f(op.data, op.cols, x_padded)

    return spmv


def pad_x_for_ring(x: np.ndarray, op: RingELL, mesh: Mesh, dtype):
    xp = np.zeros(op.x_pad, dtype=np.float64)
    xp[: x.shape[0]] = x
    return jax.device_put(jnp.asarray(xp, dtype=dtype), NamedSharding(mesh, P(ROWS)))


# ---------------------------------------------------------------------------
# 4) Row-sharded DIA with ppermute halo exchange — the banded path
# ---------------------------------------------------------------------------


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["offsets", "shape", "nnz", "s_local"],
)
@dataclasses.dataclass
class ShardedDIA:
    """Diagonal slab row-sharded over the mesh; x is row-sharded too and the
    shift reach (pad_lo rows back, pad_hi ahead) crosses shard boundaries
    via a one-step ppermute halo exchange.

    Out-of-range x at the global edges is covered by the format invariant
    that diagonal data is zero wherever i + offset falls outside the matrix,
    so wrap-around halo values multiply zero coefficients.
    """

    data: jax.Array  # (D, nd * s_local) sharded P(None, rows)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0
    s_local: int = 0

    @property
    def pad_lo(self) -> int:
        return max(0, -self.offsets[0])

    @property
    def pad_hi(self) -> int:
        return max(0, self.offsets[-1])


def prepare_dia_sharded(mat, mesh: Mesh) -> ShardedDIA:
    """Shard a DeviceDIA's row axis across mesh[ROWS]."""
    nd = mesh.shape[ROWS]
    d, m_pad = mat.data.shape
    total = _ceil_to(max(m_pad, mat.shape[1], nd * LANE), nd * LANE)
    s_local = total // nd
    if max(mat.pad_lo, mat.pad_hi) > s_local:
        raise ValueError(
            f"diagonal reach {max(mat.pad_lo, mat.pad_hi)} rows exceeds "
            f"local shard {s_local}"
        )
    data = jnp.pad(mat.data, ((0, 0), (0, total - m_pad)))
    return ShardedDIA(
        data=jax.device_put(data, NamedSharding(mesh, P(None, ROWS))),
        offsets=mat.offsets,
        shape=mat.shape,
        nnz=mat.nnz,
        s_local=s_local,
    )


def pad_x_for_dia_sharded(x, op: ShardedDIA, mesh: Mesh, dtype):
    """x -> zero-padded to the sharded row count, row-sharded."""
    total = op.s_local * mesh.shape[ROWS]
    xp = jnp.pad(jnp.asarray(x, dtype), (0, total - x.shape[0]))
    return jax.device_put(xp, NamedSharding(mesh, P(ROWS)))


def make_dia_sharded(mesh: Mesh, op_meta: ShardedDIA):
    """y = A @ x, both row-sharded; halo via one ppermute per direction."""
    nd = mesh.shape[ROWS]
    lo, hi = op_meta.pad_lo, op_meta.pad_hi
    offsets = op_meta.offsets
    s_local = op_meta.s_local

    def local(data, x_loc):
        # left halo: my last lo entries go to my right neighbor, so I
        # receive my left neighbor's tail (device 0 receives wrap-around
        # values, masked by the zero coefficients at the global edge)
        parts = [x_loc]
        if lo:
            parts.insert(0, jax.lax.ppermute(
                x_loc[-lo:], ROWS, [(j, (j + 1) % nd) for j in range(nd)]
            ))
        if hi:
            parts.append(jax.lax.ppermute(
                x_loc[:hi], ROWS, [(j, (j - 1) % nd) for j in range(nd)]
            ))
        xp = jnp.concatenate(parts)
        acc = jnp.zeros(s_local, data.dtype)
        for k, off in enumerate(offsets):
            acc = acc + data[k] * xp[lo + off : lo + off + s_local]
        return acc

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, ROWS), P(ROWS)),
        out_specs=P(ROWS),
    )

    @jax.jit
    def spmv(op: ShardedDIA, x_padded):
        return f(op.data, x_padded)

    return spmv
