"""ctypes bindings to the native C++ ingestion backend (native/spmv_native.cpp).

The native library is the runtime analog of the reference's C ingestion layer
(mmio.c + parser.c); this wrapper handles decompression in Python, calls the
C ABI for parse/convert, and falls back to the pure-Python implementations in
io/mmio.py when the library is not built.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..formats.matrix import COOMatrix, CSRMatrix, ELLMatrix

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libspmv_native.so"),
    os.path.join(os.path.dirname(__file__), "libspmv_native.so"),
]

_ERRORS = {
    1: "invalid MatrixMarket banner",
    2: "unsupported matrix type (dense/complex/skew?)",
    3: "invalid size line",
    4: "invalid entry",
    5: "entry count mismatch with header",
    6: "entry index out of bounds",
    7: "allocation failure",
}


class _SpmvCoo(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int64),
        ("n", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("rows", ctypes.POINTER(ctypes.c_int64)),
        ("cols", ctypes.POINTER(ctypes.c_int64)),
        ("vals", ctypes.POINTER(ctypes.c_double)),
        ("row_lens", ctypes.POINTER(ctypes.c_int64)),
    ]


_lib: Optional[ctypes.CDLL] = None


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        if os.path.exists(p):
            lib = ctypes.CDLL(os.path.abspath(p))
            lib.spmv_parse_mtx.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.POINTER(_SpmvCoo),
            ]
            lib.spmv_parse_mtx.restype = ctypes.c_int
            lib.spmv_free_coo.argtypes = [ctypes.POINTER(_SpmvCoo)]
            lib.spmv_coo_to_csr.restype = ctypes.c_int
            lib.spmv_coo_to_ell.restype = ctypes.c_int
            _lib = lib
            return lib
    return None


def available() -> bool:
    return load_library() is not None


def parse_mtx_bytes(data: bytes) -> COOMatrix:
    """Parse a MatrixMarket body (already decompressed) natively."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    out = _SpmvCoo()
    rc = lib.spmv_parse_mtx(data, len(data), ctypes.byref(out))
    if rc != 0:
        raise ValueError(f"native parse failed: {_ERRORS.get(rc, rc)}")
    try:
        nnz, m = int(out.nnz), int(out.m)
        rows = np.ctypeslib.as_array(out.rows, shape=(nnz,)).copy() if nnz else np.empty(0, np.int64)
        cols = np.ctypeslib.as_array(out.cols, shape=(nnz,)).copy() if nnz else np.empty(0, np.int64)
        vals = np.ctypeslib.as_array(out.vals, shape=(nnz,)).copy() if nnz else np.empty(0, np.float64)
        rl = np.ctypeslib.as_array(out.row_lens, shape=(max(m, 1),))[:m].copy()
    finally:
        lib.spmv_free_coo(ctypes.byref(out))
    return COOMatrix((m, int(out.n)), rows, cols, vals, row_lens=rl)


def read_coo_native(path: str) -> COOMatrix:
    """File -> sorted COO via the native parser (with transparent
    decompression handled Python-side). Runs the entries through sort_coo so
    duplicate-entry merging matches the pure-Python reader exactly."""
    from ..formats.convert import sort_coo
    from .mmio import _open_maybe_compressed

    with _open_maybe_compressed(path) as f:
        data = f.read()
    out = sort_coo(parse_mtx_bytes(data))
    out.compute_row_lens()  # dedup merging may change lengths; recompute
    return out


def coo_to_csr_native(coo: COOMatrix) -> CSRMatrix:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built")
    m = coo.shape[0]
    rl = coo.compute_row_lens().astype(np.int64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    indices = np.zeros(coo.nnz, dtype=np.int64)
    data = np.zeros(coo.nnz, dtype=np.float64)
    rc = lib.spmv_coo_to_csr(
        ctypes.c_int64(m),
        ctypes.c_int64(coo.nnz),
        np.ascontiguousarray(coo.rows, dtype=np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.ascontiguousarray(coo.cols, dtype=np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.ascontiguousarray(coo.vals, dtype=np.float64).ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise ValueError(f"native COO->CSR failed: {_ERRORS.get(rc, rc)}")
    return CSRMatrix(coo.shape, indptr, indices, data, row_lens=rl)


_CAP_DEFAULT = object()  # sentinel: "apply the default ELL cap"


def coo_to_ell_native(coo: COOMatrix, max_entries=_CAP_DEFAULT) -> ELLMatrix:
    """max_entries=None disables the cap, matching convert.coo_to_ell."""
    from ..config import ELL_MAX_ENTRIES
    from ..formats.convert import EllSizeError

    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built")
    m = coo.shape[0]
    rl = coo.compute_row_lens().astype(np.int64)
    w = int(rl.max(initial=0))
    cap = ELL_MAX_ENTRIES if max_entries is _CAP_DEFAULT else max_entries
    if cap is not None and 2 * m * w > cap:
        raise EllSizeError(f"ELL padded entries 2*{m}*{w} exceed cap {cap}")
    wa = max(w, 1)
    ja = np.zeros((m, wa), dtype=np.int64)
    data = np.zeros((m, wa), dtype=np.float64)
    rc = lib.spmv_coo_to_ell(
        ctypes.c_int64(m),
        ctypes.c_int64(coo.nnz),
        np.ascontiguousarray(coo.rows, dtype=np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.ascontiguousarray(coo.cols, dtype=np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.ascontiguousarray(coo.vals, dtype=np.float64).ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(wa),
        ja.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise ValueError(f"native COO->ELL failed: {_ERRORS.get(rc, rc)}")
    return ELLMatrix(coo.shape, ja, data, max_row_nz=w, nnz=coo.nnz, row_lens=rl)
