"""Sparse matrix core data model (COO / CSR / ELL).

Capability analog of the reference's single `spmat` struct
(reference: src/include/sparseMatrix.h:25-42, which packs CSR IRP/JA/AS, ELL
MAX_ROW_NZ + padded slabs, optional RL row lengths, and CUDA pitches into one
type). Here each format is its own host-side dataclass, plus device-side
pytree containers:

- CSR device form carries an *expanded row-id vector* (one row id per nnz,
  padded to an aligned length with an out-of-range segment id) so row
  reductions become segment-sums — the replacement for IRP-driven scalar
  loops.
- ELL device form pads the slab width to a multiple of 128 lanes (the
  cudaMallocPitch analog, reference cudaUtils.cu:56-98) and optionally holds a
  transposed (W, M) layout, the analog of the reference's ellTranspose
  coalescing trick (sparseUtils.c:145-185).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import LANE, SUBLANE


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def int_div_ceil(a: int, b: int) -> int:
    """Reference INT_DIV_CEIL analog (macros.h:29)."""
    return (a + b - 1) // b


def fair_block_size(i: int, base: int, rem: int) -> int:
    """Remainder-balanced block size for worker i.

    Reference UNIF_REMINDER_DISTRI analog (macros.h:33-34): the first `rem`
    workers get base+1 items, the rest get base.
    """
    return base + (1 if i < rem else 0)


def fair_block_start(i: int, base: int, rem: int) -> int:
    """Start index of worker i's fair block (macros.h:35-36 analog)."""
    return i * base + min(i, rem)


def fair_splits(n: int, parts: int) -> np.ndarray:
    """Boundaries of a remainder-balanced split of range(n) into `parts`.

    Returns an array of parts+1 offsets; block p = [out[p], out[p+1]).
    """
    base, rem = divmod(n, parts)
    out = np.empty(parts + 1, dtype=np.int64)
    for p in range(parts + 1):
        out[p] = p * base + min(p, rem)
    return out


# ---------------------------------------------------------------------------
# Host-side formats (numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format sparse matrix, entries sorted by (row, col).

    Analog of the reference's parsed `entry*` array + rowLens
    (parser.h:24-35).
    """

    shape: Tuple[int, int]
    rows: np.ndarray  # (nnz,) int
    cols: np.ndarray  # (nnz,) int
    vals: np.ndarray  # (nnz,) float
    row_lens: Optional[np.ndarray] = None  # (M,) int

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    def compute_row_lens(self) -> np.ndarray:
        if self.row_lens is None:
            self.row_lens = np.bincount(
                self.rows, minlength=self.shape[0]
            ).astype(np.int64)
        return self.row_lens

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=np.float64)
        np.add.at(d, (self.rows, self.cols), self.vals)
        return d


@dataclasses.dataclass
class CSRMatrix:
    """CSR host matrix: indptr (IRP analog), indices (JA), data (AS)."""

    shape: Tuple[int, int]
    indptr: np.ndarray  # (M+1,) int
    indices: np.ndarray  # (nnz,) int
    data: np.ndarray  # (nnz,) float
    row_lens: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def compute_row_lens(self) -> np.ndarray:
        if self.row_lens is None:
            self.row_lens = np.diff(self.indptr).astype(np.int64)
        return self.row_lens

    @property
    def max_row_nz(self) -> int:
        return int(self.compute_row_lens().max(initial=0))

    def row_ids(self) -> np.ndarray:
        """Expanded per-nnz row ids (segment ids for device reductions)."""
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int32), self.compute_row_lens()
        )

    def to_dense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=np.float64)
        rl = self.compute_row_lens()
        d[np.repeat(np.arange(self.shape[0]), rl), self.indices] = self.data
        return d


@dataclasses.dataclass
class ELLMatrix:
    """ELLPACK host matrix: row-major padded (M, max_row_nz) slabs.

    Padding value convention matches the reference: values 0.0, column index 0
    (calloc'd, parser.c:279-296 + config.h:71 ELL_AS_FILLER).
    """

    shape: Tuple[int, int]
    ja: np.ndarray  # (M, W) int — or (W, M) when slab_transposed
    data: np.ndarray  # (M, W) float — or (W, M) when slab_transposed
    max_row_nz: int
    nnz: int
    row_lens: Optional[np.ndarray] = None
    #: slabs stored (W, M) (host-side ellTranspose analog); device_ell
    #: performs its own transposition and expects (M, W) input
    slab_transposed: bool = False

    def to_dense(self) -> np.ndarray:
        if self.slab_transposed:
            import dataclasses as _dc

            return _dc.replace(
                self,
                ja=self.ja.T.copy(),
                data=self.data.T.copy(),
                slab_transposed=False,
            ).to_dense()
        d = np.zeros(self.shape, dtype=np.float64)
        m, w = self.ja.shape
        rl = self.row_lens
        if rl is None:
            # treat rows as full width: padded slots are (ja=0, val=0) and
            # contribute nothing; counting nonzeros would wrongly truncate
            # rows containing explicitly stored zeros
            rl = np.full(m, w, dtype=np.int64)
        for r in range(m):
            for k in range(int(rl[r])):
                d[r, self.ja[r, k]] += self.data[r, k]
        return d


# ---------------------------------------------------------------------------
# Device-side containers (JAX pytrees)
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceCSR:
    """Device CSR: nnz-expanded arrays + aligned padding.

    `row_ids[k]` is the output row of nnz k; padded tail entries carry
    row_id == M (dropped by segment-sum with num_segments=M), col 0, val 0.
    `indptr` is retained for block-partitioned kernels.
    """

    data: jax.Array  # (nnz_pad,) dtype
    cols: jax.Array  # (nnz_pad,) int32
    row_ids: jax.Array  # (nnz_pad,) int32
    indptr: jax.Array  # (M+1,) int32
    row_lens: jax.Array  # (M,) int32
    shape: Tuple[int, int] = dataclasses.field(default=(0, 0))
    nnz: int = 0

    def tree_flatten(self):
        return (
            (self.data, self.cols, self.row_ids, self.indptr, self.row_lens),
            (self.shape, self.nnz),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, cols, row_ids, indptr, row_lens = children
        shape, nnz = aux
        return cls(data, cols, row_ids, indptr, row_lens, shape, nnz)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceELL:
    """Device ELL: lane-aligned (M_pad, W_pad) slabs (+ optional transpose).

    W_pad is max_row_nz rounded up to a LANE multiple; M_pad rounds rows to a
    SUBLANE multiple. Transposed layout (W_pad, M_pad) mirrors the reference's
    ellTranspose coalescing variant (sparseUtils.c:145-185) with rows on the
    contiguous axis.
    """

    data: jax.Array  # (M_pad, W_pad) dtype
    cols: jax.Array  # (M_pad, W_pad) int32
    row_lens: jax.Array  # (M_pad,) int32
    shape: Tuple[int, int] = dataclasses.field(default=(0, 0))
    nnz: int = 0
    max_row_nz: int = 0
    transposed: bool = False

    def tree_flatten(self):
        return (
            (self.data, self.cols, self.row_lens),
            (self.shape, self.nnz, self.max_row_nz, self.transposed),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, cols, row_lens = children
        shape, nnz, max_row_nz, transposed = aux
        return cls(data, cols, row_lens, shape, nnz, max_row_nz, transposed)


def device_csr(
    csr: CSRMatrix,
    dtype=jnp.float32,
    nnz_align: int = LANE * SUBLANE,
) -> DeviceCSR:
    """Upload a host CSR to device form (the spMatCpyCSR analog,
    reference cudaUtils.cu:20-55, redesigned: expansion + alignment padding
    instead of raw pointer copies)."""
    m, _ = csr.shape
    nnz = csr.nnz
    nnz_pad = max(_ceil_to(max(nnz, 1), nnz_align), nnz_align)
    data = np.zeros(nnz_pad, dtype=np.float64)
    cols = np.zeros(nnz_pad, dtype=np.int32)
    rids = np.full(nnz_pad, m, dtype=np.int32)
    data[:nnz] = csr.data
    cols[:nnz] = csr.indices
    rids[:nnz] = csr.row_ids()
    return DeviceCSR(
        data=jnp.asarray(data, dtype=dtype),
        cols=jnp.asarray(cols),
        row_ids=jnp.asarray(rids),
        indptr=jnp.asarray(csr.indptr, dtype=jnp.int32),
        row_lens=jnp.asarray(csr.compute_row_lens(), dtype=jnp.int32),
        shape=csr.shape,
        nnz=nnz,
    )


def device_ell(
    ell: ELLMatrix,
    dtype=jnp.float32,
    transposed: bool = False,
    lane_pad: bool = True,
) -> DeviceELL:
    """Upload a host ELL to a lane-aligned device slab (spMatCpyELL analog,
    reference cudaUtils.cu:56-98; pitch == the aligned padded width).

    Layout-dependent padding to (SUBLANE, LANE) = (8, 128) multiples:
    - row-major (M, W): W -> multiple of 128, M -> multiple of 8.
    - transposed (W, M): W -> multiple of 8 only, M -> multiple of 128. For
      narrow matrices (max_row_nz << 128) the transposed layout avoids a
      large padding blowup, and consecutive rows are adjacent in memory —
      the reference's coalescing-motivated ellTranspose.
    """
    assert not getattr(ell, "slab_transposed", False), (
        "pass the untransposed host ELL; device_ell transposes itself"
    )
    m, _ = ell.shape
    w = ell.max_row_nz
    if transposed:
        w_pad = max(_ceil_to(max(w, 1), SUBLANE), SUBLANE)
        m_pad = max(_ceil_to(max(m, 1), LANE), LANE)
    else:
        w_pad = max(_ceil_to(max(w, 1), LANE), LANE) if lane_pad else max(w, 1)
        m_pad = max(_ceil_to(max(m, 1), SUBLANE), SUBLANE)
    data = np.zeros((m_pad, w_pad), dtype=np.float64)
    cols = np.zeros((m_pad, w_pad), dtype=np.int32)
    rl = np.zeros(m_pad, dtype=np.int32)
    data[:m, :w] = ell.data
    cols[:m, :w] = ell.ja
    if ell.row_lens is not None:
        rl[:m] = ell.row_lens
    else:
        rl[:m] = w  # full width: padded slots hold value 0 (see to_dense)
    if transposed:
        data, cols = data.T.copy(), cols.T.copy()
    return DeviceELL(
        data=jnp.asarray(data, dtype=dtype),
        cols=jnp.asarray(cols),
        row_lens=jnp.asarray(rl),
        shape=ell.shape,
        nnz=ell.nnz,
        max_row_nz=w,
        transposed=transposed,
    )


def is_nnz(csr: CSRMatrix, i: int, j: int) -> bool:
    """Membership query: is (i, j) a stored nonzero? Binary search within the
    row's column-sorted segment (reference IS_NNZ / BISECT_ARRAY analog,
    sparseMatrix.h:54-80)."""
    lo, hi = int(csr.indptr[i]), int(csr.indptr[i + 1])
    k = int(np.searchsorted(csr.indices[lo:hi], j))
    return k < hi - lo and csr.indices[lo + k] == j
