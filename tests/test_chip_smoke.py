"""chip_smoke.py's phases at tiny sizes on the CPU (the card runs them at
the proxies' sizes), and its refusal to report without a GPU."""
import json

import jax
import pytest

import chip_smoke as C

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.utils import synth


def _small():
    return {
        "banded": S.coo_to_csr(synth.banded(3000, 3000, 29, seed=1)),
        "powerlaw": S.coo_to_csr(synth.power_law(2000, 2000, 5.0, seed=2)),
    }


def test_phase_device_refuses_cpu():
    with pytest.raises(C.SmokeFailure, match="no GPU"):
        C.phase_device(1)


def test_main_without_gpu_prints_no_result(capsys):
    assert C.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_phase_dia_small(capsys):
    csrs = _small()
    C.phase_dia({"banded": csrs["banded"]}, "test-card")
    out = capsys.readouterr().out
    assert out.count("us/call on test-card") == 3  # f32, bf16 slab, f64


def test_phase_auto_small(capsys):
    C.phase_auto(_small(), "test-card")
    out = capsys.readouterr().out
    assert "banded float64: format=dia" in out
    assert "powerlaw float32: format=binned" in out


def test_phase_cli_small(tmp_path, capsys):
    C.phase_cli(synth.banded(800, 800, 10, fill=1.0, exact_nnz=16000, seed=4),
                str(tmp_path))
    assert capsys.readouterr().out.count("#check: OK") == 2


def test_phase_solvers_small(capsys):
    C.phase_solvers(20_000, "test-card")
    out = capsys.readouterr().out
    assert "CG float32" in out and "CG float64" in out
    assert "power iteration" in out


def test_phase_sharded_virtual(capsys):
    csrs = _small()
    C.phase_sharded(csrs["powerlaw"], csrs["banded"], jax.devices()[:4],
                    "test-card")
    assert capsys.readouterr().out.count("on 4 GPUs") == 4


def test_relative_error_rejects_f32_noise_in_f64():
    # the f64 bound is tight enough to catch a float32 result
    import numpy as np

    csr = _small()["banded"]
    x = C.unit_x(csr.shape[1])
    from spmv_openmp_cuda_tpu.ops.oracle import serial_csr_spmv

    y32 = serial_csr_spmv(csr, x).astype(np.float32)
    with pytest.raises(C.SmokeFailure):
        C.check_result(y32, csr, x, "float64", "f32 result")
    C.check_result(y32, csr, x, "float32", "f32 result")
