"""AutoSpMV model API: format selection + end-to-end correctness."""
import numpy as np
import pytest

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.models.auto import AutoSpMV, select_format
from spmv_openmp_cuda_tpu.io.mmio import write_mtx
from spmv_openmp_cuda_tpu.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu.utils import synth
from spmv_openmp_cuda_tpu.utils.compare import vectors_diff

from spmv_openmp_cuda_tpu.utils.compare import relative_error

from matrix_regimes import MATRICES


def test_select_format_policy():
    assert select_format(S.coo_to_csr(synth.banded(500, 500, 5, seed=1))) == "dia"
    # every matrix DIA rejects goes to the row-binned engine, bounded rows
    # and power-law hubs alike
    uniform = S.coo_to_csr(synth.random_uniform(2000, 2000, 0.004, seed=4))
    assert select_format(uniform) == "binned"
    tiny = S.coo_to_csr(synth.power_law(400, 400, 5.0, seed=2))
    assert select_format(tiny) == "binned"
    big = S.coo_to_csr(synth.power_law(10000, 10000, 3.0, seed=3))
    assert select_format(big) == "binned"


@pytest.mark.parametrize("gen,fmt", [
    (lambda: synth.banded(300, 300, 6, fill=0.95, seed=4), "dia"),
    (lambda: synth.power_law(300, 280, 5.0, seed=5), "binned"),
    (lambda: synth.power_law(9000, 9000, 4.0, seed=7), "binned"),
    (lambda: synth.random_uniform(3000, 3000, 0.003, seed=8), "binned"),
])
def test_auto_spmv_correct(gen, fmt):
    coo = gen()
    csr = S.coo_to_csr(coo)
    model = AutoSpMV.from_csr(csr)
    assert model.format == fmt
    x = fill_rnd_vector(coo.shape[1], seed=6)
    y = np.asarray(model(x), np.float64)
    rep = vectors_diff(y, serial_csr_spmv(csr, x))
    assert rep.ok, rep


def test_auto_spmv_forced_format():
    coo = synth.banded(200, 200, 4, seed=7)
    csr = S.coo_to_csr(coo)
    for fmt in ("dia", "ell_t", "binned"):
        model = AutoSpMV.from_csr(csr, format=fmt)
        assert model.format == fmt
        x = fill_rnd_vector(200, seed=8)
        rep = vectors_diff(np.asarray(model(x), np.float64), serial_csr_spmv(csr, x))
        assert rep.ok, (fmt, rep)


def test_auto_spmv_from_file(tmp_path):
    coo = synth.banded(100, 100, 3, seed=9)
    p = str(tmp_path / "m.mtx")
    write_mtx(p, coo)
    model = AutoSpMV.from_file(p)
    x = fill_rnd_vector(100, seed=10)
    rep = vectors_diff(
        np.asarray(model(x), np.float64),
        serial_csr_spmv(S.coo_to_csr(coo), x),
    )
    assert rep.ok


def test_auto_spmv_float64_uses_xla_paths():
    # float64 runs the same engines natively (no emulation)
    from spmv_openmp_cuda_tpu.config import Config

    for gen, want in [
        (synth.banded(400, 400, 4, seed=2), "dia"),
        (synth.power_law(500, 500, 5.0, seed=3), "binned"),
    ]:
        csr = S.coo_to_csr(gen)
        model = AutoSpMV.from_csr(csr, cfg=Config(dtype="float64"))
        assert model.format == want
        x = fill_rnd_vector(csr.shape[1], seed=4)
        y = model(x)
        assert y.dtype == np.float64
        rep = vectors_diff(np.asarray(y, np.float64), serial_csr_spmv(csr, x))
        assert rep.ok, rep


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mat_name", list(MATRICES))
def test_auto_spmv_matrix_regimes(mat_name, dtype):
    """AutoSpMV on every kernel-test regime, relative to
    max_i sum_j |a_ij x_j| with unit-scale x: f32 within 1e-5, native f64
    within 1e-12 (the summation order alone separates it from the oracle)."""
    import jax

    from spmv_openmp_cuda_tpu.config import Config

    before = jax.config.jax_enable_x64
    try:
        coo = MATRICES[mat_name]
        csr = S.coo_to_csr(coo)
        model = AutoSpMV.from_csr(csr, cfg=Config(dtype=dtype))
        x = np.random.default_rng(3).uniform(-1, 1, coo.shape[1])
        err = relative_error(model(x), csr, x)
    finally:
        jax.config.update("jax_enable_x64", before)
    assert err <= (1e-12 if dtype == "float64" else 1e-5), (model.format, err)


def test_auto_spmv_unknown_format():
    csr = S.coo_to_csr(synth.banded(200, 200, 3, seed=1))
    with pytest.raises(ValueError, match="unknown format"):
        AutoSpMV.from_csr(csr, format="csr")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_auto_spmv_on_gpu(gpu, dtype):
    """Card only: the engines AUTO picks, compiled by XLA:GPU, at a size
    where the GPU's reduction order differs from the CPU's."""
    import jax

    from spmv_openmp_cuda_tpu.config import Config

    before = jax.config.jax_enable_x64
    try:
        for coo in (synth.banded(200_000, 200_000, 13, seed=1),
                    synth.power_law(200_000, 200_000, 6.0, seed=2)):
            csr = S.coo_to_csr(coo)
            model = AutoSpMV.from_csr(csr, cfg=Config(dtype=dtype))
            assert next(iter(model(np.zeros(csr.shape[1])).devices())) == gpu
            x = np.random.default_rng(3).uniform(-1, 1, csr.shape[1])
            err = relative_error(model(x), csr, x)
            assert err <= (1e-12 if dtype == "float64" else 1e-5), err
    finally:
        jax.config.update("jax_enable_x64", before)
