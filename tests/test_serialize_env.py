"""Prepared-format serialization (checkpoint analog) + env introspection +
membership query."""
import numpy as np
import jax.numpy as jnp

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.formats.binned import binned_spmv, prepare_binned_csr
from spmv_openmp_cuda_tpu.formats.dia import dia_spmv, prepare_dia
from spmv_openmp_cuda_tpu.formats.matrix import is_nnz
from spmv_openmp_cuda_tpu.formats.serialize import load_prepared, save_prepared
from spmv_openmp_cuda_tpu.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu.utils import synth
from spmv_openmp_cuda_tpu.utils.compare import vectors_diff
from spmv_openmp_cuda_tpu.utils.envinfo import format_info, runtime_info


def test_serialize_roundtrip_binned(tmp_path):
    csr = S.coo_to_csr(synth.power_law(200, 200, 5.0, seed=1))
    x = fill_rnd_vector(200, seed=2)
    mat = prepare_binned_csr(csr)
    p = str(tmp_path / "m.npz")
    save_prepared(p, mat)
    back = load_prepared(p)
    y = np.asarray(binned_spmv(back, jnp.asarray(x, jnp.float32)), np.float64)
    assert vectors_diff(y, serial_csr_spmv(csr, x)).ok


def test_serialize_roundtrip_dia(tmp_path):
    csr = S.coo_to_csr(synth.banded(150, 150, 4, seed=3))
    x = fill_rnd_vector(150, seed=4)
    mat = prepare_dia(csr)
    p = str(tmp_path / "d.npz")
    save_prepared(p, mat)
    back = load_prepared(p)
    assert back.offsets == mat.offsets
    y = np.asarray(dia_spmv(back, jnp.asarray(x, jnp.float32)), np.float64)
    assert vectors_diff(y, serial_csr_spmv(csr, x)).ok


def test_serialize_roundtrip_ell(tmp_path):
    coo = synth.banded(100, 100, 3, seed=5)
    ell = S.coo_to_ell(coo)
    mat = S.device_ell(ell, transposed=True)
    p = str(tmp_path / "e.npz")
    save_prepared(p, mat)
    back = load_prepared(p)
    assert back.transposed and back.shape == mat.shape
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(mat.data))


def test_env_info():
    info = runtime_info()
    assert info["backend"] == "cpu" and info["device_count"] == 8
    assert "jax_version" in format_info()
    # the card's name and power limit are reported on the gpu backend only
    assert "gpu_name_power_limit" not in info


def test_is_nnz():
    coo = synth.banded(50, 50, 2, seed=6)
    csr = S.coo_to_csr(coo)
    dense = coo.to_dense()
    for i in (0, 10, 49):
        for j in (0, 9, 12, 49):
            assert is_nnz(csr, i, j) == (dense[i, j] != 0)


def test_gpu_name_power_without_nvidia_smi(monkeypatch):
    from spmv_openmp_cuda_tpu.utils import envinfo

    monkeypatch.setenv("PATH", "/nonexistent")
    assert envinfo.gpu_name_power() is None


def test_serialize_roundtrip_dia_bf16(tmp_path):
    csr = S.coo_to_csr(synth.banded(300, 300, 6, seed=2))
    mat = prepare_dia(csr, dtype=jnp.bfloat16)
    p = str(tmp_path / "b.npz")
    save_prepared(p, mat)
    back = load_prepared(p)
    assert back.data.dtype == jnp.bfloat16 and back.offsets == mat.offsets
    x = jnp.asarray(fill_rnd_vector(300, seed=3), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(dia_spmv(mat, x)), np.asarray(dia_spmv(back, x))
    )
