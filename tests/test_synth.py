"""Honesty invariants of the benchmark proxies (VERDICT round 1, Missing#1).

The round-1 proxies idealized thermal2/FEM_3D_thermal2 as perfect dense
bands (DIA-eligible) and silently lost nnz to duplicate draws. These tests
pin the round-2 contract: exact published nnz, unstructured-FEM proxies
scattered over thousands of distinct offsets, DIA rejection for them, and
reproducibility under a fixed seed.
"""
import numpy as np
import pytest

from spmv_openmp_cuda_tpu.formats.convert import coo_to_csr
from spmv_openmp_cuda_tpu.formats.dia import DiaFillError, prepare_dia
from spmv_openmp_cuda_tpu.models.auto import select_format
from spmv_openmp_cuda_tpu.utils import synth

# proxy -> (n, exact published nnz)  [SuiteSparse; BASELINE.md corpus]
EXACT = {
    "delaunay_n12_like": (4096, 24528),
    "raefsky1_like": (3242, 293409),
    "cavity10_like": (2597, 76367),
    "caida_like": (192244, 1218132),
    "west2021_like": (2021, 7310),
    "sg_like": (144649, 2148786),
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_proxy_exact_nnz(name):
    n, nnz = EXACT[name]
    coo = synth.preset(name, seed=0)
    assert coo.shape == (n, n)
    assert coo.nnz == nnz
    # distinct entries (sort_coo collapsed none)
    key = coo.rows.astype(np.int64) * n + coo.cols
    assert np.unique(key).shape[0] == nnz


def test_fem_proxy_structure():
    """Scaled-down fem_like: scattered offsets, not DIA-eligible, exact nnz."""
    coo = synth.fem_like(
        m=20000, n=20000, nnz=140000, spread=1024, lo=1, hi=11, seed=3
    )
    assert coo.nnz == 140000
    csr = coo_to_csr(coo)
    offs = np.unique(csr.indices - csr.row_ids())
    assert offs.shape[0] > 1000  # thousands of distinct offsets
    assert np.abs(offs).max() <= 1024  # locality window respected
    lens = np.diff(csr.indptr)
    assert lens.min() >= 1
    with pytest.raises(DiaFillError):
        prepare_dia(csr)
    # a general engine, not DIA
    assert select_format(csr) == "binned"
    # diagonal present on every row (FEM)
    diag_mask = csr.indices == csr.row_ids()
    assert np.bincount(csr.row_ids()[diag_mask], minlength=20000).min() == 1


def test_fem_proxy_reproducible():
    a = synth.fem_like(m=5000, n=5000, nnz=34000, spread=512, lo=1, hi=11, seed=7)
    b = synth.fem_like(m=5000, n=5000, nnz=34000, spread=512, lo=1, hi=11, seed=7)
    assert np.array_equal(a.rows, b.rows)
    assert np.array_equal(a.cols, b.cols)
    assert np.array_equal(a.vals, b.vals)


def test_power_law_exact_nnz():
    coo = synth.power_law(
        m=5000, n=5000, avg_nnz_per_row=4.0, alpha=1.7, seed=1, exact_nnz=20000
    )
    assert coo.nnz == 20000


def test_banded_exact_nnz_tops_up_full_band():
    # fill=1.0 band has no free in-band slot: top-up must widen to 2*bw
    coo = synth.banded(m=500, n=500, bandwidth=5, fill=1.0, exact_nnz=5600, seed=0)
    assert coo.nnz == 5600
    offs = coo.cols.astype(np.int64) - coo.rows
    assert np.abs(offs).max() <= 10
