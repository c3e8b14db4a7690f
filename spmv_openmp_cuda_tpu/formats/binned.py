"""Row-binned jagged-ELL device format ("binned CSR").

An answer to the reference's CSR kernels (SURVEY.md section 7 "hard
parts"): IRP-driven scalar loops don't vectorize, and nnz-stream
segment-sums lower to a scatter. Instead, rows
are permuted by length (the row_binning pass = the reference's
dynamic-scheduling/chunk-balance analog, ompChunksDivide.h) and grouped into
width classes; each class is a dense transposed (W_c, M_c) slab, so the whole
matrix is a handful of dense lane-parallel multiply-reduces with total memory
proportional to nnz (bounded padding per class) — CSR's memory economics with
ELL's vectorization.

Output assembly is a *gather* by precomputed position (scatter-free): the
per-class results are concatenated and each original row reads its slot.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LANE, SUBLANE
from ..partition.partitioners import row_binning
from .matrix import CSRMatrix, _ceil_to


def width_classes(max_w: int) -> List[int]:
    """Width-class boundaries: 8, 16, 32, ... (SUBLANE-aligned doubling).

    Doubling bounds per-row padding below 2x (plus alignment), the same
    waste envelope the reference accepts for ELL as a whole but applied
    per class.
    """
    out = [SUBLANE]
    while out[-1] < max_w:
        out.append(out[-1] * 2)
    return out


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["slab_data", "slab_cols", "out_pos"],
    meta_fields=["class_offsets", "class_widths", "class_layouts", "shape", "nnz"],
)
@dataclasses.dataclass
class BinnedCSR:
    """Width-class slabs packed into one flat buffer.

    Class widths are jagged, so each class slab is stored flattened in one 1D
    buffer and sliced at trace time via static metadata
    (class_offsets/class_widths/class_layouts) — the pytree stays a fixed
    small set of arrays regardless of class count.
    """

    slab_data: jax.Array  # 1D buffer: concat of per-class slabs
    slab_cols: jax.Array  # 1D int32 buffer, same layout
    out_pos: jax.Array  # (M_pad,) int32: position of row i in concat outputs
    class_offsets: Tuple[int, ...]  # start offset of class c in the buffer
    class_widths: Tuple[Tuple[int, int], ...]  # (W_c, M_c) per class
    #: per-class layout: "t" = transposed (W_c, M_c) rows-on-lanes (narrow
    #: classes with many rows), "r" = row-major (M_c, W_c) (wide classes with
    #: few rows, where lane-padding M_c would dominate the footprint)
    class_layouts: Tuple[str, ...] = ()
    shape: Tuple[int, int] = (0, 0)
    nnz: int = 0


def prepare_binned_csr(csr: CSRMatrix, dtype=jnp.float32) -> BinnedCSR:
    m, n = csr.shape
    rl = csr.compute_row_lens()
    order = row_binning(rl)  # descending length (chunk-balance analog)
    sorted_lens = rl[order]

    classes = width_classes(int(rl.max(initial=1)))
    # assign rows (in sorted order) to classes; rows of length 0 go to the
    # smallest class (they read padding and produce 0)
    buf_data: List[np.ndarray] = []
    buf_cols: List[np.ndarray] = []
    class_offsets: List[int] = []
    class_widths: List[Tuple[int, int]] = []
    # position of each sorted row in the concatenated per-class outputs
    out_positions = np.zeros(m, dtype=np.int64)

    class_layouts: List[str] = []
    offset = 0
    out_base = 0
    start = 0
    for w in reversed(classes):  # largest class first (sorted_lens descending)
        lo = classes[classes.index(w) - 1] if classes.index(w) > 0 else 0
        # rows with lo < len <= w
        end = start
        while end < m and sorted_lens[end] > lo:
            end += 1
        if w == classes[0]:
            end = m  # smallest class takes everything left (incl. len 0)
        cnt = end - start
        if cnt == 0 and w != classes[0]:
            start = end
            continue
        # slabs align to (SUBLANE, LANE): transposed slabs pad rows to 128,
        # row-major slabs pad the width to 128. Pick the layout with the
        # smaller padded footprint for this class.
        phys_t = w * _ceil_to(max(cnt, 1), LANE)
        phys_r = _ceil_to(max(cnt, 1), SUBLANE) * _ceil_to(w, LANE)
        layout = "t" if phys_t <= phys_r else "r"
        if layout == "t":
            m_c = max(_ceil_to(max(cnt, 1), LANE), LANE)
        else:
            m_c = max(_ceil_to(max(cnt, 1), SUBLANE), SUBLANE)
        data_c = np.zeros((w, m_c), dtype=np.float64)
        cols_c = np.zeros((w, m_c), dtype=np.int32)
        if cnt:
            rows_in_class = order[start:end]
            lens_c = sorted_lens[start:end]
            total = int(lens_c.sum())
            if total:
                row_rep = np.repeat(np.arange(cnt), lens_c)
                within = np.arange(total) - np.repeat(
                    np.cumsum(lens_c) - lens_c, lens_c
                )
                src = csr.indptr[rows_in_class][row_rep] + within
                data_c[within, row_rep] = csr.data[src]
                cols_c[within, row_rep] = csr.indices[src]
        if layout == "r":
            data_c, cols_c = data_c.T.copy(), cols_c.T.copy()
        buf_data.append(data_c.ravel())
        buf_cols.append(cols_c.ravel())
        class_offsets.append(offset)
        class_widths.append((w, m_c))
        class_layouts.append(layout)
        out_positions[start:end] = out_base + np.arange(cnt)
        offset += w * m_c
        out_base += m_c
        start = end

    out_pos = np.zeros(max(_ceil_to(max(m, 1), LANE), LANE), dtype=np.int32)
    out_pos[order] = out_positions
    return BinnedCSR(
        slab_data=jnp.asarray(np.concatenate(buf_data), dtype=dtype),
        slab_cols=jnp.asarray(np.concatenate(buf_cols)),
        out_pos=jnp.asarray(out_pos),
        class_offsets=tuple(class_offsets),
        class_widths=tuple(class_widths),
        class_layouts=tuple(class_layouts),
        shape=(m, n),
        nnz=csr.nnz,
    )


def binned_spmv(mat: BinnedCSR, x: jax.Array) -> jax.Array:
    """y = A @ x over width-class slabs: per class a dense transposed-ELL
    multiply-reduce (rows on lanes), then scatter-free assembly by gather."""
    parts = []
    for off, (w, m_c), layout in zip(
        mat.class_offsets, mat.class_widths, mat.class_layouts
    ):
        shape = (w, m_c) if layout == "t" else (m_c, w)
        data = jax.lax.dynamic_slice(mat.slab_data, (off,), (w * m_c,)).reshape(shape)
        cols = jax.lax.dynamic_slice(mat.slab_cols, (off,), (w * m_c,)).reshape(shape)
        xg = x[cols].astype(data.dtype)
        parts.append(jnp.sum(data * xg, axis=0 if layout == "t" else 1))
    concat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    m = mat.shape[0]
    return concat[mat.out_pos][:m]
