"""Every registered kernel vs the oracles, across matrix regimes
(the reference's harness-as-test shape, SURVEY.md section 4)."""
import numpy as np
import pytest

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.config import Config, DOUBLE_DIFF_THRESH
from spmv_openmp_cuda_tpu.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu.ops import registry
from spmv_openmp_cuda_tpu.ops.oracle import (
    dense_gemv_oracle,
    oracle_vs_oracle,
    serial_csr_spmv,
)
from spmv_openmp_cuda_tpu.utils import synth
from spmv_openmp_cuda_tpu.utils.compare import vectors_diff

from matrix_regimes import DIA_MODES, MATRICES

CFG = Config(dtype="float32", avg_times_iteration=1)

def _prep(coo):
    csr = S.coo_to_csr(coo)
    ell = S.coo_to_ell(coo)
    # bounded-magnitude inputs per the reference protocol (MAXRND)
    x = fill_rnd_vector(coo.shape[1], seed=5)
    return csr, ell, x


@pytest.mark.parametrize("mat_name", list(MATRICES))
def test_oracle_vs_oracle(mat_name):
    """TESTTESTS mode (SpMV_test.cu:227-236 analog)."""
    csr, _, x = _prep(MATRICES[mat_name])
    rep = oracle_vs_oracle(csr, x)
    assert rep.ok, rep


@pytest.mark.parametrize("mat_name", list(MATRICES))
@pytest.mark.parametrize("kname", registry.names())
def test_kernel_matches_oracle(mat_name, kname):
    from spmv_openmp_cuda_tpu.formats.dia import DiaFillError

    coo = MATRICES[mat_name]
    csr, ell, x = _prep(coo)
    oracle = serial_csr_spmv(csr, x)
    spec = registry.get(kname)

    import jax, jax.numpy as jnp

    try:
        operands = spec.prepare(csr, ell, CFG)
    except DiaFillError:
        # DIA legitimately rejects diagonal-sparse matrices (the ELL-size-cap
        # analog); the harness records this and moves on.
        assert kname in DIA_MODES
        return
    f = spec.jitted(operands)
    y = np.asarray(f(jnp.asarray(x, dtype=CFG.jnp_dtype)), dtype=np.float64)
    rep = vectors_diff(y[: csr.shape[0]], oracle, DOUBLE_DIFF_THRESH)
    assert rep.ok, f"{kname} on {mat_name}: {rep}"


def test_float64_parity():
    """f64 path stays available for oracle-parity runs (SURVEY.md hard parts)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        coo = MATRICES["banded"]
        csr, ell, x = _prep(coo)
        cfg = Config(dtype="float64", avg_times_iteration=1)
        spec = registry.get("CSR_ROWS")
        f = spec.jitted(spec.prepare(csr, ell, cfg))
        import jax.numpy as jnp

        y = np.asarray(f(jnp.asarray(x, dtype=jnp.float64)))
        np.testing.assert_allclose(y, serial_csr_spmv(csr, x), atol=1e-12)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_rectangular_shapes():
    for m, n in [(50, 200), (200, 50), (1, 40), (40, 1)]:
        coo = synth.random_uniform(m, n, 0.1, seed=9)
        if coo.nnz == 0:
            continue
        csr, ell, x = _prep(coo)
        oracle = dense_gemv_oracle(csr, x)
        import jax.numpy as jnp

        for kname in ("CSR_ROWS", "ELL_ROWS", "ELL_ROWS_T", "CSR_TILES"):
            spec = registry.get(kname)
            f = spec.jitted(spec.prepare(csr, ell, CFG))
            y = np.asarray(f(jnp.asarray(x, dtype=CFG.jnp_dtype)), np.float64)
            rep = vectors_diff(y[:m], oracle)
            assert rep.ok, f"{kname} {m}x{n}: {rep}"
