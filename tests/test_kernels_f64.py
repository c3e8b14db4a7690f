"""Every float64-capable registry mode vs the oracle in native float64, on
the same matrix regimes as test_kernels.py.

The bound is relative to max_i sum_j |a_ij x_j| with x of unit scale: the
reference protocol's 7e-4 absolute bound on |x| < 3e-5 inputs would pass
float32 results too. Native float64 sums in another order than the oracle,
so a few ulps of that scale separate them; 1e-12 leaves room for that and
none for a float32 or emulated path."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spmv_openmp_cuda_tpu.config import Config
from spmv_openmp_cuda_tpu.formats.dia import DiaFillError
from spmv_openmp_cuda_tpu.ops import registry
from spmv_openmp_cuda_tpu.utils.compare import relative_error

from matrix_regimes import DIA_MODES, MATRICES

import spmv_openmp_cuda_tpu as S

F64_MODES = [s.name for s in registry.all_kernels() if s.f64]
REL_TOL = 1e-12


@pytest.fixture
def x64():
    """x64 is process-global: enable it for the test, restore after."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def test_bf16_modes_refuse_float64():
    assert {"DIA_BF16"} == {
        s.name for s in registry.all_kernels() if not s.f64
    }


@pytest.mark.parametrize("mat_name", list(MATRICES))
@pytest.mark.parametrize("kname", F64_MODES)
def test_kernel_f64_matches_oracle(x64, mat_name, kname):
    coo = MATRICES[mat_name]
    csr = S.coo_to_csr(coo)
    ell = S.coo_to_ell(coo)
    x = np.random.default_rng(5).uniform(-1, 1, coo.shape[1])
    spec = registry.get(kname)
    try:
        ops = spec.prepare(csr, ell, Config(dtype="float64"))
    except DiaFillError:
        assert kname in DIA_MODES
        return
    y = spec.jitted(ops)(jnp.asarray(x, jnp.float64))
    assert y.dtype == jnp.float64
    err = relative_error(y, csr, x)
    assert err <= REL_TOL, f"{kname} on {mat_name}: {err:.2e}"
