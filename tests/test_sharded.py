"""Sharded SpMV on an 8-virtual-device CPU mesh (fake-mesh testing the
reference has no analog of — SURVEY.md section 4 implication)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import spmv_openmp_cuda_tpu as S
from spmv_openmp_cuda_tpu.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu.io.vectors import fill_rnd_vector
from spmv_openmp_cuda_tpu.parallel import mesh as M
from spmv_openmp_cuda_tpu.parallel import sharded as sh
from spmv_openmp_cuda_tpu.utils import synth
from spmv_openmp_cuda_tpu.utils.compare import vectors_diff


def _mats():
    coo = synth.power_law(190, 170, 5.0, seed=21)
    csr = S.coo_to_csr(coo)
    ell = S.coo_to_ell(coo)
    x = fill_rnd_vector(coo.shape[1], seed=2)
    return csr, ell, x, serial_csr_spmv(csr, x)


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_ell_rows_sharded(mesh_shape):
    csr, ell, x, oracle = _mats()
    mesh = M.make_mesh(mesh_shape)
    op = sh.prepare_row_sharded_ell(ell, mesh)
    spmv = sh.make_ell_rows_sharded(mesh)
    xj = jnp.asarray(x, dtype=jnp.float32)
    y = np.asarray(spmv(op, xj), dtype=np.float64)[: op.m]
    rep = vectors_diff(y, oracle)
    assert rep.ok, rep


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (1, 4)])
def test_csr_cols_psum(mesh_shape):
    csr, ell, x, oracle = _mats()
    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = M.make_mesh(mesh_shape, devices=jax.devices()[:n_dev])
    op = sh.prepare_col_sharded_csr(csr, mesh)
    spmv = sh.make_csr_cols_psum(mesh, csr.shape[0])
    xj = sh.pad_x_for_col_sharding(x, op, mesh, jnp.float32)
    y = np.asarray(spmv(op, xj), dtype=np.float64)
    rep = vectors_diff(y, oracle)
    assert rep.ok, rep


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_ell_ring(n_dev):
    csr, ell, x, oracle = _mats()
    mesh = M.make_mesh((n_dev, 1), devices=jax.devices()[:n_dev])
    op = sh.prepare_ring_ell(csr, mesh)
    spmv = sh.make_ell_ring(mesh, op)
    xj = sh.pad_x_for_ring(x, op, mesh, jnp.float32)
    y = np.asarray(spmv(op, xj), dtype=np.float64)[: op.m]
    rep = vectors_diff(y, oracle)
    assert rep.ok, rep


def test_ring_prepare_covers_all_nnz():
    csr, _, _, _ = _mats()
    mesh = M.make_mesh((4, 1), devices=jax.devices()[:4])
    op = sh.prepare_ring_ell(csr, mesh)
    assert int((np.asarray(op.data) != 0).sum()) <= csr.nnz
    # reconstruct dense from slabs and compare
    d, m_loc, w_s, cw = op.d, op.m_loc, op.w_s, op.chunk_w
    data = np.asarray(op.data, dtype=np.float64).reshape(d, m_loc, d, w_s)
    cols = np.asarray(op.cols).reshape(d, m_loc, d, w_s)
    dense = np.zeros((d * m_loc, d * cw))
    for dev in range(d):
        for r in range(m_loc):
            for s in range(d):
                for k in range(w_s):
                    v = data[dev, r, s, k]
                    if v != 0:
                        dense[dev * m_loc + r, s * cw + cols[dev, r, s, k]] += v
    ref = csr.to_dense()
    np.testing.assert_allclose(dense[: csr.shape[0], : csr.shape[1]], ref)


def test_dia_sharded_halo():
    from spmv_openmp_cuda_tpu.formats.dia import prepare_dia
    from spmv_openmp_cuda_tpu.parallel.sharded import (
        make_dia_sharded,
        pad_x_for_dia_sharded,
        prepare_dia_sharded,
    )

    mesh = M.make_mesh((8, 1))
    coo = synth.banded(5000, 5000, 140, fill=0.3, seed=7)  # reach 140
    csr = S.coo_to_csr(coo)
    mat = prepare_dia(csr, max_fill_ratio=1e9)
    x = fill_rnd_vector(5000, seed=8)
    op = prepare_dia_sharded(mat, mesh)
    xs = pad_x_for_dia_sharded(np.asarray(x), op, mesh, jnp.float32)
    y = np.asarray(make_dia_sharded(mesh, op)(op, xs), np.float64)
    y = y.reshape(-1)[: csr.shape[0]]
    rep = vectors_diff(y, serial_csr_spmv(csr, x))
    assert rep.ok, rep


def test_scaling_harness_smoke(capsys):
    from spmv_openmp_cuda_tpu.bench.scaling import run_scaling

    rc = run_scaling("cavity10_like", [1, 2], "dia_halo")
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("preset,path,virtual,devices,time_s,efficiency,ok")


def test_ring_overlap_dependency_structure():
    # the ring body's multiply must consume the PRE-permute chunk (the
    # portable half of the comm/compute-overlap claim; the async
    # start/done split is XLA's scheduler's decision on the GPU)
    import re

    mesh = M.make_mesh((8, 1))
    coo = synth.power_law(512, 512, 5.0, seed=3)
    csr = S.coo_to_csr(coo)
    op = sh.prepare_ring_ell(csr, mesh)
    x = sh.pad_x_for_ring(
        np.asarray(fill_rnd_vector(512, seed=4)), op, mesh, jnp.float32
    )
    spmv = sh.make_ell_ring(mesh, op)
    text = str(jax.make_jaxpr(spmv)(op, x))
    pp = [ln for ln in text.splitlines() if "ppermute" in ln]
    assert pp, "no ppermute in ring jaxpr"
    for ln in pp:
        m = re.match(r"\s*([a-z]+)(?:\[[^\]]*\])?\s*=", ln)
        if not m:
            continue
        v = m.group(1)
        bad = [
            u for u in text.splitlines()
            if re.search(rf"\b{re.escape(v)}\b", u) and "=" in u
            and not u.strip().startswith(v)
            and any(o in u for o in ("mul", "dot_general", "add_any"))
        ]
        assert not bad, f"ppermute output {v} feeds arithmetic: {bad}"


def test_dia_sharded_halo_one_sided_band():
    # upper-triangular band: no left halo (pad_lo = 0), right halo only
    from spmv_openmp_cuda_tpu.formats.dia import prepare_dia

    coo = synth.banded(3000, 3000, 40, fill=0.5, seed=12)
    keep = coo.cols >= coo.rows
    coo = S.COOMatrix(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    csr = S.coo_to_csr(coo)
    mat = prepare_dia(csr, max_fill_ratio=1e9)
    assert mat.pad_lo == 0 and mat.pad_hi > 0
    mesh = M.make_mesh((4, 1), devices=jax.devices()[:4])
    op = sh.prepare_dia_sharded(mat, mesh)
    x = fill_rnd_vector(3000, seed=13)
    xs = sh.pad_x_for_dia_sharded(np.asarray(x), op, mesh, jnp.float32)
    y = np.asarray(sh.make_dia_sharded(mesh, op)(op, xs), np.float64)[:3000]
    assert vectors_diff(y, serial_csr_spmv(csr, x)).ok


def test_dryrun_multichip_virtual(capsys):
    import __graft_entry__ as g

    g.dryrun_multichip(4)
    assert "all OK" in capsys.readouterr().out
