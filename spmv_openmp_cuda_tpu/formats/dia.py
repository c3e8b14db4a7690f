"""DIA (diagonal) device format — the zero-gather SpMV path.

The reference stores banded FEM/thermal matrices (its headline benchmarks) as
CSR/ELL and pays per-nnz index reads plus random x access
(reference: src/SpMV_ELL_OMP.c:33-67, src/SpMV_CUDA.cu:79-96). Stored by
diagonal instead, y = sum_d diag_d * (x shifted by offset_d): no column
indices (half the bytes of ELL), no gather (each shift is one contiguous
slice of a zero-padded x), and every read runs along rows, so it coalesces.
This is the speed-of-light format whenever the matrix's nnz concentrate on
few diagonals.

Layout: the slab is diagonal-major, data[d, i] = A[i, i + offsets[d]] for
row i < m_pad (0 where the column falls outside the matrix). x is padded
once by pad_lo = max(0, -min offset) zeros in front and pad_hi = max(0, max
offset) behind, so row i of diagonal d reads xp[pad_lo + offsets[d] + i],
always in bounds.

Like the reference's ELL size cap (parser.c:223-232), conversion enforces a
padding budget: if the dense diagonals would exceed `max_fill_ratio` x nnz,
DiaFillError is raised and callers fall back to a general engine.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LANE
from .matrix import CSRMatrix, _ceil_to


class DiaFillError(ValueError):
    """Diagonal materialization would exceed the padding budget."""


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["offsets", "shape", "nnz"],
)
@dataclasses.dataclass
class DeviceDIA:
    """data[d, i] = A[i, i + offsets[d]] (0 where outside the matrix)."""

    data: jax.Array  # (D, m_pad)
    offsets: Tuple[int, ...]  # static: diagonal offsets (c - r), ascending
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0

    @property
    def m_pad(self) -> int:
        return self.data.shape[1]

    @property
    def pad_lo(self) -> int:
        return max(0, -self.offsets[0]) if self.offsets else 0

    @property
    def pad_hi(self) -> int:
        return max(0, self.offsets[-1]) if self.offsets else 0


def prepare_dia(
    csr: CSRMatrix, dtype=jnp.float32, max_fill_ratio: float = 3.0
) -> DeviceDIA:
    m, n = csr.shape
    rows = csr.row_ids()
    uniq, inv = np.unique(csr.indices - rows.astype(np.int64), return_inverse=True)
    m_pad = max(_ceil_to(max(m, 1), LANE), LANE)
    if uniq.shape[0] * m_pad > max_fill_ratio * max(csr.nnz, 1):
        raise DiaFillError(
            f"{uniq.shape[0]} diagonals x {m_pad} rows = "
            f"{uniq.shape[0] * m_pad} slots > {max_fill_ratio}x nnz ({csr.nnz})"
        )
    data = np.zeros((uniq.shape[0], m_pad), dtype=np.float64)
    data[inv, rows] = csr.data
    return DeviceDIA(
        data=jnp.asarray(data, dtype=dtype),
        offsets=tuple(int(o) for o in uniq),
        shape=(m, n),
        nnz=csr.nnz,
    )


def pad_x_dia(x: jax.Array, mat: DeviceDIA) -> jax.Array:
    """x -> [pad_lo zeros | x | zeros], length pad_lo + m_pad + pad_hi.

    Entries past m_pad + pad_hi, the last one a diagonal can read (wide
    matrices, n >> m), are clipped."""
    reach = mat.m_pad + mat.pad_hi
    xc = x[:reach]
    return jnp.pad(xc, (mat.pad_lo, reach - xc.shape[0]))


def dia_spmv(mat: DeviceDIA, x: jax.Array) -> jax.Array:
    """y = A @ x: one static slice of the padded x per diagonal, which XLA
    fuses into a single pass over the slab. bf16 slabs accumulate in f32."""
    acc_t = jnp.promote_types(mat.data.dtype, jnp.float32)
    xp = pad_x_dia(x.astype(acc_t), mat)
    m_pad, lo = mat.m_pad, mat.pad_lo
    acc = jnp.zeros(m_pad, dtype=acc_t)
    for i, off in enumerate(mat.offsets):
        acc = acc + mat.data[i].astype(acc_t) * xp[lo + off : lo + off + m_pad]
    return acc[: mat.shape[0]]
