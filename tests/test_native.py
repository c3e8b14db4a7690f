"""Native C++ ingestion backend vs the pure-Python reference implementation."""
import numpy as np
import pytest

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.formats.matrix import COOMatrix
from spmv_openmp_cuda_tpu.formats.convert import sort_coo
from spmv_openmp_cuda_tpu.io import native as N
from spmv_openmp_cuda_tpu.io.mmio import read_coo, write_mtx
from spmv_openmp_cuda_tpu.utils import synth

pytestmark = pytest.mark.skipif(
    not N.available(), reason="native library not built (make -C native)"
)


def _roundtrip(tmp_path, coo, **write_kw):
    p = str(tmp_path / "m.mtx")
    write_mtx(p, coo, **write_kw)
    return read_coo(p), N.read_coo_native(p)


def test_native_matches_python_general(tmp_path):
    coo = synth.power_law(300, 280, 5.0, seed=3)
    a, b = _roundtrip(tmp_path, coo)
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_allclose(a.vals, b.vals)
    np.testing.assert_array_equal(a.compute_row_lens(), b.row_lens)


def test_native_symmetric_expansion(tmp_path):
    d = np.zeros((40, 40))
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 40, size=(60, 2))
    for i, j in idx:
        d[i, j] = d[j, i] = rng.standard_normal()
    r, c = np.nonzero(d)
    coo = sort_coo(COOMatrix((40, 40), r, c, d[r, c]))
    a, b = _roundtrip(tmp_path, coo, symmetry="symmetric")
    np.testing.assert_allclose(b.to_dense(), d)
    np.testing.assert_array_equal(a.rows, b.rows)


def test_native_pattern(tmp_path):
    coo = COOMatrix((5, 5), np.array([0, 2, 4]), np.array([1, 3, 0]), np.ones(3))
    _, b = _roundtrip(tmp_path, coo, field="pattern")
    np.testing.assert_allclose(b.vals, 1.0)


def test_native_rejects_garbage():
    with pytest.raises(ValueError):
        N.parse_mtx_bytes(b"not a matrix\n1 1 1\n")
    with pytest.raises(ValueError):
        N.parse_mtx_bytes(
            b"%%MatrixMarket matrix coordinate real general\n2 2 5\n1 1 1.0\n"
        )
    with pytest.raises(ValueError):  # out of bounds entry
        N.parse_mtx_bytes(
            b"%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n"
        )


def test_native_converters_match(tmp_path):
    coo = synth.banded(100, 100, 6, fill=0.8, seed=5)
    csr_py = S.coo_to_csr(coo)
    csr_nat = N.coo_to_csr_native(coo)
    np.testing.assert_array_equal(csr_py.indptr, csr_nat.indptr)
    np.testing.assert_array_equal(csr_py.indices, csr_nat.indices)
    np.testing.assert_allclose(csr_py.data, csr_nat.data)
    ell_py = S.coo_to_ell(coo)
    ell_nat = N.coo_to_ell_native(coo)
    assert ell_py.max_row_nz == ell_nat.max_row_nz
    np.testing.assert_array_equal(ell_py.ja, ell_nat.ja)
    np.testing.assert_allclose(ell_py.data, ell_nat.data)


def test_native_ell_cap(tmp_path):
    from spmv_openmp_cuda_tpu.formats.convert import EllSizeError

    coo = synth.banded(30, 30, 3, seed=1)
    with pytest.raises(EllSizeError):
        N.coo_to_ell_native(coo, max_entries=1)


def test_native_rejects_nonsquare_symmetric(tmp_path):
    pytest.importorskip("ctypes")
    from spmv_openmp_cuda_tpu.io import native

    if not native.available():
        pytest.skip("native lib not built")
    body = b"%%MatrixMarket matrix coordinate real symmetric\n2 3 1\n1 3 1.0\n"
    with pytest.raises(ValueError):
        native.parse_mtx_bytes(body)


def test_native_crlf_banner(tmp_path):
    from spmv_openmp_cuda_tpu.io import native

    if not native.available():
        pytest.skip("native lib not built")
    body = b"%%MatrixMarket matrix coordinate real general\r\n2 2 1\r\n1 2 1.5\r\n"
    coo = native.parse_mtx_bytes(body)
    assert coo.shape == (2, 2) and coo.nnz == 1


def test_native_library_fresh():
    """The built .so must not be older than its source (a stale binary
    silently diverges from spmv_native.cpp; rebuild with make -C native)."""
    import os

    so = next(p for p in N._LIB_PATHS if os.path.exists(p))
    cpp = os.path.join(os.path.dirname(so), "spmv_native.cpp")
    if os.path.exists(cpp):
        assert os.path.getmtime(so) >= os.path.getmtime(cpp), (
            "native/libspmv_native.so is older than spmv_native.cpp — "
            "run make -C native"
        )
