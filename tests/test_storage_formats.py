"""Binned-CSR and DIA storage engines: correctness + policy tests."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.formats.binned import (
    BinnedCSR,
    binned_spmv,
    prepare_binned_csr,
    width_classes,
)
from spmv_openmp_cuda_tpu.formats.dia import (
    DiaFillError,
    dia_spmv,
    prepare_dia,
)
from spmv_openmp_cuda_tpu.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu.utils import synth
from spmv_openmp_cuda_tpu.utils.compare import vectors_diff


def _check(mat_fn, coo):
    csr = S.coo_to_csr(coo)
    x = fill_rnd_vector(coo.shape[1], seed=5)
    mat, run = mat_fn(csr)
    y = np.asarray(jax.jit(run)(mat, jnp.asarray(x, jnp.float32)), np.float64)
    rep = vectors_diff(y, serial_csr_spmv(csr, x))
    assert rep.ok, rep
    return mat


MATS = {
    "powerlaw": synth.power_law(400, 380, 6.0, seed=3),
    "banded": synth.banded(256, 256, 9, fill=0.9, seed=2),
    "uniform": synth.random_uniform(200, 300, 0.05, seed=1),
    "diag": synth.diagonal(100),
    "single_row": synth.banded(1, 50, 30, seed=1),
}


@pytest.mark.parametrize("name", list(MATS))
def test_binned_csr_correct(name):
    _check(lambda csr: (prepare_binned_csr(csr), binned_spmv), MATS[name])


def test_binned_memory_bounded():
    # slab footprint stays within ~2x nnz + per-class alignment for large
    # skewed matrices (CSR economics, SURVEY.md section 7 hard part 1)
    coo = synth.power_law(30000, 30000, 8.0, seed=4)
    csr = S.coo_to_csr(coo)
    mat = prepare_binned_csr(csr)
    assert mat.slab_data.size <= 4 * csr.nnz + len(mat.class_offsets) * 128 * 512


def test_width_classes_doubling():
    assert width_classes(1) == [8]
    assert width_classes(8) == [8]
    assert width_classes(9) == [8, 16]
    assert width_classes(100) == [8, 16, 32, 64, 128]


def test_binned_row_permutation_roundtrip():
    coo = synth.power_law(500, 500, 5.0, seed=7)
    csr = S.coo_to_csr(coo)
    mat = prepare_binned_csr(csr)
    # out_pos must be a valid injective map over rows
    pos = np.asarray(mat.out_pos)[: csr.shape[0]]
    assert len(np.unique(pos)) == csr.shape[0]


@pytest.mark.parametrize("name", ["banded", "diag"])
def test_dia_correct(name):
    _check(lambda csr: (prepare_dia(csr, max_fill_ratio=100.0), dia_spmv), MATS[name])


def test_dia_rectangular():
    for m, n in [(100, 200), (200, 100)]:
        _check(
            lambda csr: (prepare_dia(csr, max_fill_ratio=100.0), dia_spmv),
            synth.banded(m, n, 5, seed=1),
        )


def test_dia_fill_cap():
    csr = S.coo_to_csr(synth.random_uniform(100, 100, 0.02, seed=1))
    with pytest.raises(DiaFillError):
        prepare_dia(csr, max_fill_ratio=3.0)


def test_dia_offsets_sound():
    coo = synth.banded(128, 128, 4, fill=1.0, seed=0)
    csr = S.coo_to_csr(coo)
    mat = prepare_dia(csr)
    assert mat.offsets == tuple(range(-4, 5))
    # diagonal data roundtrip: reconstruct dense
    dense = np.zeros((128, 128))
    data = np.asarray(mat.data, np.float64).reshape(len(mat.offsets), -1)
    for i, off in enumerate(mat.offsets):
        for r in range(128):
            c = r + off
            if 0 <= c < 128:
                dense[r, c] = data[i, r]
    np.testing.assert_allclose(dense, coo.to_dense(), atol=1e-6)


def test_dia_wide_band():
    # diagonal reach (300) far beyond the 128-row alignment
    csr = S.coo_to_csr(synth.banded(600, 600, 300, fill=0.05, seed=3))
    mat = prepare_dia(csr, max_fill_ratio=1e9)
    assert mat.pad_lo == 300 and mat.pad_hi == 300
    x = fill_rnd_vector(600, seed=6)
    y = np.asarray(jax.jit(dia_spmv)(mat, jnp.asarray(x, jnp.float32)), np.float64)
    assert vectors_diff(y, serial_csr_spmv(csr, x)).ok


def test_dia_wide_matrix_far_band():
    # short matrix, far-off diagonal (reach >> m): pad_x_dia must clip
    # n >> row reach and keep every shifted slice in bounds
    from spmv_openmp_cuda_tpu.formats.matrix import COOMatrix
    from spmv_openmp_cuda_tpu.formats.convert import sort_coo

    m, n = 2560, 65536
    rows = np.arange(m)
    cols = rows + 60000
    ok = cols < n
    rng = np.random.default_rng(44)
    coo = sort_coo(COOMatrix((m, n), rows[ok], cols[ok], rng.standard_normal(ok.sum())))
    csr = S.coo_to_csr(coo)
    mat = prepare_dia(csr, max_fill_ratio=1e9)
    x = fill_rnd_vector(n, seed=45)
    y = np.asarray(dia_spmv(mat, jnp.asarray(x, jnp.float32)), np.float64)
    assert vectors_diff(y, serial_csr_spmv(csr, x)).ok


def test_dia_bf16_slab_accumulates_in_f32():
    from spmv_openmp_cuda_tpu.utils.compare import relative_error

    csr = S.coo_to_csr(synth.banded(2000, 2000, 20, seed=5))
    x = np.random.default_rng(6).uniform(-1, 1, 2000)
    mat = prepare_dia(csr, dtype=jnp.bfloat16)
    y = dia_spmv(mat, jnp.asarray(x, jnp.float32))
    assert y.dtype == jnp.float32
    # bf16 keeps 8 mantissa bits of each value; sums stay f32
    assert relative_error(y, csr, x) <= 8e-3
