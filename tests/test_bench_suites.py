"""Static contract of bench.py's suites (every entry names a real synth
preset and registered kernels, so a typo fails here and not on the card),
its record file, and its refusal to measure without a GPU."""
import importlib.util
import json
import os
import sys

from spmv_openmp_cuda_tpu.ops import registry
from spmv_openmp_cuda_tpu.utils import synth


def _bench_module():
    path = os.path.join(os.path.dirname(__file__), "..", "bench.py")
    spec = importlib.util.spec_from_file_location("bench_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bench_under_test"] = mod
    spec.loader.exec_module(mod)  # main() is not called on import
    return mod


def test_suite_entries_resolve():
    bench = _bench_module()
    modes = set(registry.names())
    for suite in (
        bench.SUITE, bench.F64_SUITE, bench.EXT_SUITE, bench.EXT_F64_SUITE
    ):
        for preset, ref_gflops, candidates in suite:
            assert preset in synth.PRESETS, preset
            assert ref_gflops > 0
            assert candidates, preset
            for name in candidates:
                assert name in modes, name
    for extra in (bench.AB_EXTRA, bench.F64_AB_EXTRA):
        for preset, candidates in extra.items():
            assert preset in synth.PRESETS, preset
            for name in candidates:
                assert name in modes, name


def test_f64_suite_uses_f64_capable_modes():
    bench = _bench_module()
    for suite in (bench.F64_SUITE, bench.EXT_F64_SUITE):
        for preset, _ref, candidates in suite:
            for name in candidates:
                assert registry.get(name).f64, (
                    f"{name} is a bf16-storage mode in the f64 suite"
                )
    for preset, candidates in bench.F64_AB_EXTRA.items():
        for name in candidates:
            assert registry.get(name).f64, name


def test_build_suite_bench_cands_pins_candidates(monkeypatch):
    """BENCH_CANDS replaces every selected proxy's candidate list
    verbatim."""
    import bench as B

    monkeypatch.setenv("BENCH_ONLY", "thermal2_like")
    monkeypatch.setenv("BENCH_CANDS", "ELL_ROWS_T,CSR_ROWS")
    suite, _ext, _dt, _n = B.build_suite()
    assert [s[0] for s in suite] == ["thermal2_like"]
    assert suite[0][2] == ["ELL_ROWS_T", "CSR_ROWS"]


def test_build_suite_selects_by_env(monkeypatch):
    import bench as B

    monkeypatch.setenv("BENCH_SUITE", "extended")
    monkeypatch.setenv("SPMV_DTYPE", "float64")
    suite, ext, dtype, n = B.build_suite()
    assert (ext, dtype, n) == (True, "float64", len(B.EXT_F64_SUITE))
    assert suite == B.EXT_F64_SUITE


def test_emit_partial_writes_dot_partial(tmp_path, monkeypatch, capsys):
    """Incomplete suites persist under a .partial name: measured rows
    survive without clobbering a complete record."""
    import bench as B

    monkeypatch.setenv("BENCH_DETAILS_DIR", str(tmp_path))
    rows = [
        {"matrix": "a", "ratio": 2.0, "gflops": 10.0},
        {"matrix": "b", "ratio": 4.0, "gflops": 20.0},
    ]
    B.emit(rows, extended=True, dtype="float64", base_len=5)
    out = capsys.readouterr().out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["proxies_measured"] == 2 and rec["proxies_total"] == 5
    p = tmp_path / "BENCH_DETAILS_EXTENDED_F64.json.partial"
    assert p.exists()
    assert not (tmp_path / "BENCH_DETAILS_EXTENDED_F64.json").exists()
    assert json.loads(p.read_text()) == rows


def test_bench_refuses_without_gpu(monkeypatch, capsys):
    """No GPU: a non-zero exit and no JSON result line (a CPU number is
    never reported as a device measurement)."""
    import bench as B

    monkeypatch.setattr(B, "measure_proxy", lambda *a: (_ for _ in ()).throw(
        AssertionError("measured without a GPU")))
    assert B.main() == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no GPU" in captured.err
