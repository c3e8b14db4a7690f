"""Harness, CLI, sweep, and log-reducer integration tests."""
import io
import json
import os
import sys

import numpy as np
import pytest

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.bench.harness import format_log, run_all
from spmv_openmp_cuda_tpu.bench.parse_log import parse_lines, pivot_by_matrix, write_csv
from spmv_openmp_cuda_tpu.bench.sweep import sweep
from spmv_openmp_cuda_tpu.cli import main as cli_main
from spmv_openmp_cuda_tpu.config import Config
from spmv_openmp_cuda_tpu.io.mmio import write_mtx
from spmv_openmp_cuda_tpu.io.vectors import fill_rnd_vector, write_vector_str
from spmv_openmp_cuda_tpu.utils import synth

CFG = Config(avg_times_iteration=2)
KERNELS = ["CSR_ROWS", "ELL_ROWS", "CSR_TILES"]


def _mat():
    coo = synth.banded(64, 64, 4, fill=0.9, seed=3)
    return coo, S.coo_to_csr(coo), S.coo_to_ell(coo)


def test_run_all_and_log_roundtrip():
    coo, csr, ell = _mat()
    x = fill_rnd_vector(64, seed=0)
    report = run_all(csr, ell, x, CFG, kernels=KERNELS, name="banded64")
    assert report.all_ok
    assert len(report.results) == len(KERNELS)
    text = format_log(report, CFG)
    rows = parse_lines(text.splitlines())
    assert len(rows) == len(KERNELS)
    assert {r["funcID"] for r in rows} == set(KERNELS)
    assert all(r["ok"] == "1" for r in rows)
    assert rows[0]["source"] == "banded64"
    assert rows[0]["NNZ"] == str(csr.nnz)
    # pivot produces one row per matrix with per-impl columns
    piv = pivot_by_matrix(rows)
    assert len(piv) == 1
    assert "time_CSR_ROWS" in piv[0]
    out = io.StringIO()
    write_csv(rows, out)
    assert out.getvalue().count("\n") == len(KERNELS) + 1


def test_run_all_skips_ell_when_capped():
    coo, csr, _ = _mat()
    x = fill_rnd_vector(64, seed=0)
    report = run_all(csr, None, x, CFG, kernels=KERNELS, name="nocap")
    names = {r.kernel for r in report.results}
    assert "ELL_ROWS" not in names and "CSR_ROWS" in names


def test_cli_end_to_end(tmp_path, capsys):
    coo, csr, ell = _mat()
    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, coo)
    vec = str(tmp_path / "v.txt")
    write_vector_str(vec, fill_rnd_vector(64, seed=1))
    os.environ["TMPDIR"] = str(tmp_path)
    try:
        rc = cli_main([mtx, vec, "ELL_ROWS", "--check"])
    finally:
        del os.environ["TMPDIR"]
    assert rc == 0
    out = capsys.readouterr().out
    assert "computeMode:ELL_ROWS" in out
    assert "#check: OK" in out
    assert (tmp_path / "outVectorDump").exists()
    assert (tmp_path / "outVectorDumpRaw").exists()


def test_cli_auto_mode_and_dtype(tmp_path, capsys):
    coo, csr, ell = _mat()
    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, coo)
    rc = cli_main([mtx, "RNDVECT", "AUTO", "--no-dump", "--check"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "#auto: format=" in out and "#check: OK" in out
    # f64 runs the selected engine natively (x64 flag is process-global:
    # restore it)
    import jax

    x64_before = jax.config.jax_enable_x64
    try:
        rc = cli_main(
            [mtx, "RNDVECT", "AUTO", "--no-dump", "--check", "--dtype", "float64"]
        )
    finally:
        jax.config.update("jax_enable_x64", x64_before)
    assert rc == 0
    out = capsys.readouterr().out
    from spmv_openmp_cuda_tpu.models.auto import AUTO_MODES

    assert any(f"computeMode:{m} " in out for m in AUTO_MODES.values()), out
    assert "#check: OK" in out


def test_cli_auto_dia_infeasible_falls_back(tmp_path, capsys):
    # a 40-row tridiagonal: select_format guesses dia, but the 128-row
    # padding trips the fill cap in prepare — AUTO must fall back, not crash
    coo = synth.banded(40, 40, 1, fill=1.0, seed=9)
    mtx = str(tmp_path / "tiny.mtx")
    write_mtx(mtx, coo)
    rc = cli_main([mtx, "RNDVECT", "AUTO", "--no-dump", "--check"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#check: OK" in out


def test_cli_rndvect_and_bad_mode(tmp_path, capsys):
    coo, *_ = _mat()
    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, coo)
    rc = cli_main([mtx, "RNDVECT", "CSR_ROWS", "--no-dump", "--check"])
    assert rc == 0
    assert cli_main([mtx, "RNDVECT", "NOT_A_MODE"]) == 1
    out = capsys.readouterr()
    assert "unknown compute mode" in out.err


def test_cli_vector_size_mismatch(tmp_path):
    coo, *_ = _mat()
    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, coo)
    vec = str(tmp_path / "v.txt")
    write_vector_str(vec, np.ones(7))
    assert cli_main([mtx, vec, "CSR_ROWS"]) == 1


def test_sweep_over_files_and_grids(tmp_path):
    coo, *_ = _mat()
    mtx = str(tmp_path / "a.mtx")
    write_mtx(mtx, coo)
    stream = io.StringIO()
    logs, failures = sweep(
        [mtx], grids=[(2, 2), (4, 2)], cfg_base=CFG, kernels=["CSR_ROWS"],
        log_stream=stream,
    )
    assert not failures
    rows = parse_lines(stream.getvalue().splitlines())
    assert len(rows) == 2  # one per grid config
    assert {r["grid"] for r in rows} == {"2x2", "4x2"}


def test_cli_save_load_prepared(tmp_path, capsys):
    from spmv_openmp_cuda_tpu.cli import main
    from spmv_openmp_cuda_tpu.io.mmio import write_mtx
    from spmv_openmp_cuda_tpu.utils import synth

    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, synth.power_law(600, 600, 4.0, seed=3))
    prep = str(tmp_path / "prep.npz")
    rc = main([mtx, "RNDVECT", "CSR_ROWS_BINNED", "--check", "--no-dump",
               f"--save-prepared={prep}"])
    assert rc == 0
    rc = main([mtx, "RNDVECT", "CSR_ROWS_BINNED", "--check", "--no-dump",
               f"--load-prepared={prep}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "#check: OK" in out


def test_parse_log_keeps_error_rows():
    from spmv_openmp_cuda_tpu.bench.parse_log import parse_lines

    log = [
        "#matrix: m.mtx 10 10 20 4",
        "#config: grid=8x8 dtype=float32 schedule=static reps=5 devices=1 backend=cpu",
        "@computing SpMV with func:xla CSR_ROWS",
        "CSR_ROWS wallDispatchAvg:1.0e-03 wallDispatchVar:0 "
        "internalTimeAvg:1.0e-04 "
        "internalTimeVar:0 prepTime:1e-2 GFLOPS:0.1 NNZs:1e6 ok:1 det:1",
        "@computing SpMV with func:xla CSR_TILES",
        # pre-rename schema (old committed sample logs) must still parse
        "CSR_TILES timeAvg:2.0e-03 timeVar:0 internalTimeAvg:2.0e-04 "
        "internalTimeVar:0 prepTime:1e-2 GFLOPS:0.2 NNZs:2e6 ok:1 det:1",
        "@computing SpMV with func:pallas ELL_ROWS",
        "ELL_ROWS ERROR: boom",
    ]
    rows = parse_lines(log)
    assert [r["funcID"] for r in rows] == ["CSR_ROWS", "CSR_TILES", "ELL_ROWS"]
    assert rows[0]["wallDispatchAvg"] == "1.0e-03"
    assert rows[1]["wallDispatchAvg"] == "2.0e-03"  # legacy timeAvg field
    assert rows[2]["ok"] == "0" and rows[2]["error"] == "boom"


def test_cli_testtests(tmp_path, capsys):
    from spmv_openmp_cuda_tpu.cli import main
    from spmv_openmp_cuda_tpu.io.mmio import write_mtx
    from spmv_openmp_cuda_tpu.utils import synth

    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, synth.banded(300, 300, 4, fill=0.9, seed=2))
    assert main([mtx, "RNDVECT", "--testtests", "--no-dump"]) == 0
    out = capsys.readouterr().out
    assert "#testtests: OK" in out


def test_cli_f64_pallas_mode_remaps(tmp_path, capsys):
    from spmv_openmp_cuda_tpu.cli import main
    from spmv_openmp_cuda_tpu.io.mmio import write_mtx
    from spmv_openmp_cuda_tpu.utils import synth

    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, synth.banded(300, 300, 4, fill=1.0, seed=2))
    import jax

    x64_before = jax.config.jax_enable_x64
    try:
        rc = main([mtx, "RNDVECT", "DIA_BF16", "--dtype", "float64",
                   "--check", "--no-dump"])
    finally:
        jax.config.update("jax_enable_x64", x64_before)
    assert rc == 0
    out = capsys.readouterr().out
    # a bf16 slab cannot hold float64: the mode remaps to its f64 twin
    assert "remapping to DIA_ROWS" in out
    assert "computeMode:DIA_ROWS" in out


def test_cli_save_load_prepared_dia_pallas(tmp_path, capsys):
    from spmv_openmp_cuda_tpu.cli import main
    from spmv_openmp_cuda_tpu.io.mmio import write_mtx
    from spmv_openmp_cuda_tpu.utils import synth

    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, synth.banded(400, 400, 6, fill=1.0, seed=5))
    prep = str(tmp_path / "dia.npz")
    # save under the bf16-slab DIA mode (bf16 leaves survive the .npz)
    rc = main([mtx, "RNDVECT", "DIA_BF16", "--check", "--no-dump",
               f"--save-prepared={prep}"])
    assert rc == 0
    # reload under the same mode ...
    rc = main([mtx, "RNDVECT", "DIA_BF16", "--check", "--no-dump",
               f"--load-prepared={prep}"])
    assert rc == 0
    # ... and under the f32 DIA mode (same DeviceDIA kind)
    rc = main([mtx, "RNDVECT", "DIA_ROWS", "--check", "--no-dump",
               f"--load-prepared={prep}"])
    assert rc == 0
    # kind/mode mismatch is a friendly error, not a trace crash
    rc = main([mtx, "RNDVECT", "CSR_ROWS_BINNED", "--no-dump",
               f"--load-prepared={prep}"])
    assert rc == 1
    assert "does not match mode" in capsys.readouterr().err


def test_cli_env_flag(capsys):
    # --env prints runtime introspection (reference ompGetICV.c:23-73 analog)
    rc = cli_main(["--env"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "backend:" in out
    assert "device_count:" in out
    assert "env_overrides:" in out


def test_cli_profile_trace(tmp_path, capsys):
    # --profile DIR wraps the timed chain in a jax.profiler trace capture
    coo, csr, ell = _mat()
    mtx = str(tmp_path / "m.mtx")
    write_mtx(mtx, coo)
    trace_dir = str(tmp_path / "trace")
    rc = cli_main([mtx, "RNDVECT", "CSR_ROWS", "--no-dump",
                   f"--profile={trace_dir}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "#profile:" in out
    assert "computeMode:CSR_ROWS" in out
    # the profiler wrote TensorBoard plugin events under DIR
    found = []
    for root, _dirs, files in os.walk(trace_dir):
        found.extend(files)
    assert found, "profiler trace produced no files"


def test_compile_cache_placement(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise a fixed <repo>/.jax_cache
    on the GPU and none on the CPU."""
    import jax

    from spmv_openmp_cuda_tpu.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        # the CPU backend (these tests) keeps no persistent cache
        assert compile_cache.enable_compile_cache() is None
        assert jax.config.jax_compilation_cache_dir == before
        got = compile_cache.enable_compile_cache(backend="gpu")
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
