"""Iterative solvers over the SpMV engines (models/solvers.py): the whole
solve must trace into one compiled program with the prepared format as a
pytree — covering the DIA kernel, transposed-ELL and row-binned engine
matvecs inside lax.while_loop/fori_loop control flow."""
import numpy as np
import pytest

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.formats.convert import sort_coo
from spmv_openmp_cuda_tpu.formats.matrix import COOMatrix
from spmv_openmp_cuda_tpu.models.auto import AutoSpMV
from spmv_openmp_cuda_tpu.models.solvers import (
    conjugate_gradient,
    power_iteration,
)
from spmv_openmp_cuda_tpu.utils import synth


def _spd_coo(m, half_bw, seed):
    """Symmetric positive-definite banded matrix (diagonally dominant)."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, m))
    for off in range(1, half_bw + 1):
        v = rng.standard_normal(m - off) * 0.3
        idx = np.arange(m - off)
        d[idx, idx + off] = v
        d[idx + off, idx] = v
    d[np.arange(m), np.arange(m)] = np.abs(d).sum(axis=1) + 1.0
    r, c = np.nonzero(d)
    return sort_coo(COOMatrix((m, m), r, c, d[r, c])), d


@pytest.mark.parametrize("fmt", ["dia", "ell_t", "binned"])
def test_cg_converges_on_spd_band(fmt):
    coo, dense = _spd_coo(600, 6, seed=3)
    csr = S.coo_to_csr(coo)
    model = AutoSpMV.from_csr(csr, format=fmt)
    rng = np.random.default_rng(1)
    xstar = rng.standard_normal(600)
    b = dense @ xstar
    res = conjugate_gradient(model, b.astype(np.float32), tol=1e-5,
                             maxiter=400)
    assert float(res.relres) < 1e-4, (fmt, float(res.relres))
    # f32 matvec + f32 b: expect ~1e-3-class solution accuracy
    err = np.abs(np.asarray(res.x, np.float64) - xstar).max()
    assert err < 5e-2, (fmt, err, int(res.iters))


def test_cg_double_float_engine():
    """CG runs the float64 path end-to-end (native f64 DIA kernel)."""
    import jax

    from spmv_openmp_cuda_tpu.config import Config

    before = jax.config.jax_enable_x64
    try:
        coo, dense = _spd_coo(500, 5, seed=7)
        csr = S.coo_to_csr(coo)
        model = AutoSpMV.from_csr(csr, cfg=Config(dtype="float64"))
        assert model.format == "dia"
        rng = np.random.default_rng(2)
        xstar = rng.standard_normal(500)
        b = dense @ xstar
        res = conjugate_gradient(model, b, tol=1e-10, maxiter=600)
        assert res.x.dtype == np.float64
        err = np.abs(np.asarray(res.x, np.float64) - xstar).max()
    finally:
        jax.config.update("jax_enable_x64", before)
    assert err < 1e-6, (err, int(res.iters), float(res.relres))


def test_power_iteration_dominant_eig():
    coo, dense = _spd_coo(400, 4, seed=5)
    csr = S.coo_to_csr(coo)
    model = AutoSpMV.from_csr(csr)
    res = power_iteration(model, 400, iters=300, seed=1)
    lam_ref = np.linalg.eigvalsh(dense)[-1]
    assert abs(float(res.eigenvalue) - lam_ref) / lam_ref < 1e-3


def test_cg_respects_maxiter():
    coo, dense = _spd_coo(300, 3, seed=9)
    csr = S.coo_to_csr(coo)
    model = AutoSpMV.from_csr(csr)
    b = np.ones(300, np.float32)
    res = conjugate_gradient(model, b, tol=0.0, maxiter=7)
    assert int(res.iters) == 7
