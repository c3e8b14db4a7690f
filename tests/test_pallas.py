"""The backend rule for Pallas kernels (utils/pallas_env.py): the Pallas
interpreter on the CPU backend, a compiled kernel through Triton on the
GPU, and an error on any other backend. And the DIA kernel candidates of
scripts/ab_kernels.py, run here in the interpreter against the oracle, so
the A/B on the card times kernels known to be right."""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.utils import pallas_env, synth
from spmv_openmp_cuda_tpu.utils.compare import relative_error

from matrix_regimes import MATRICES

TOL = {"f32": 1e-5, "bf16": 8e-3, "f64": 1e-12}


@pytest.mark.parametrize("backend,want", [("cpu", True), ("gpu", False)])
def test_backend_rule(backend, want):
    assert pallas_env.interpret(backend) is want


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_backend_rule_rejects_other_backends(backend):
    with pytest.raises(RuntimeError, match="no Pallas kernel route"):
        pallas_env.interpret(backend)


def test_backend_rule_follows_default_backend():
    assert pallas_env.interpret() is True  # the tests run on the cpu backend


def _load_ab():
    if "ab_kernels" not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "scripts", "ab_kernels.py")
        spec = importlib.util.spec_from_file_location("ab_kernels", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["ab_kernels"] = mod  # dataclasses look their module up
        spec.loader.exec_module(mod)
    return sys.modules["ab_kernels"]


@pytest.fixture
def ab():
    """The A/B script as a module, under x64 (restored after: global)."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield _load_ab()
    finally:
        jax.config.update("jax_enable_x64", before)


def _check(ab, variant, csr, dtype_key):
    run, ops, acc = ab.build(variant, csr, dtype_key)
    x = np.random.default_rng(5).uniform(-1, 1, csr.shape[1])
    y = jax.jit(run)(ops, jnp.asarray(x, acc))
    assert y.shape == (csr.shape[0],) and y.dtype == acc
    err = relative_error(y, csr, x)
    assert err <= TOL[dtype_key], f"{variant} {dtype_key}: {err:.2e}"
    return ops


@pytest.mark.parametrize("dtype_key", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("mat_name", ["banded", "wide_band", "wide_rect"])
@pytest.mark.parametrize("variant", ["PL_unroll_b128_w8_s3",
                                     "PL_loop_b256_w4_s2"])
def test_dia_kernel_interpret(ab, variant, mat_name, dtype_key):
    csr = S.coo_to_csr(MATRICES[mat_name])
    ops = _check(ab, variant, csr, dtype_key)
    assert ops.data.shape[1] % ops.block == 0
    assert ops.unroll == variant.startswith("PL_unroll")


def _band_with_fringe():
    """A dense band plus scattered entries far off it (raefsky1's shape)."""
    band = synth.banded(400, 400, 4, fill=1.0, seed=3)
    rng = np.random.default_rng(4)
    r = rng.integers(0, 400, 60)
    c = (r + rng.integers(20, 380, 60)) % 400
    keep = np.abs(c - r) > 8
    coo = S.COOMatrix((400, 400), np.r_[band.rows, r[keep]],
                      np.r_[band.cols, c[keep]],
                      np.r_[band.vals, rng.standard_normal(int(keep.sum()))])
    return S.coo_to_csr(S.sort_coo(coo))


@pytest.mark.parametrize("dtype_key", ["f32", "bf16", "f64"])
def test_dia_resid_kernel_interpret(ab, dtype_key):
    csr = _band_with_fringe()
    ops = _check(ab, "PL_RESID_b128", csr, dtype_key)
    assert len(ops.offsets) == 9  # the band alone forms the core
    assert int(np.count_nonzero(np.asarray(ops.rvals))) > 0


def test_parse_variant(ab):
    assert ab.parse_variant("PL_unroll_b512_w8_s3") == dict(
        resid=False, unroll=True, block=512, num_warps=8, num_stages=3)
    assert ab.parse_variant("PL_RESID_b128") == dict(
        resid=True, unroll=False, block=128)
