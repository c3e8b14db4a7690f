"""Test configuration: the CPU backend with 8 virtual devices, so the
sharded paths run without GPUs (SURVEY.md section 4: fake-mesh testing the
reference lacks) and Pallas kernels run in the interpreter.

JAX_PLATFORMS picks the platforms when set: the tier-1 command sets cpu;
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` on a GPU machine
runs the card-only tests (marker `gpu`), which skip elsewhere."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from spmv_openmp_cuda_tpu.formats.matrix import COOMatrix
from spmv_openmp_cuda_tpu.formats.convert import sort_coo


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_random_coo(m, n, density, seed=0, val_scale=1.0):
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, n)) < density) * rng.standard_normal((m, n)) * val_scale
    r, c = np.nonzero(dense)
    return sort_coo(
        COOMatrix((m, n), r.astype(np.int64), c.astype(np.int64), dense[r, c])
    ), dense


@pytest.fixture
def small_coo():
    return make_random_coo(37, 29, 0.15, seed=7)


@pytest.fixture
def medium_coo():
    return make_random_coo(300, 257, 0.03, seed=11)


@pytest.fixture
def gpu():
    """The first GPU; skips where JAX has none (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return devs[0]
