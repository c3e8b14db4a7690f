"""Oracle-checked benchmark harness.

Analog of the reference's test/SpMV_test.cu:152-389 bench harness: for one
matrix it runs *every* registered kernel, each for AVG_TIMES_ITERATION timed
repetitions, tolerance-checks every run against the serial oracle
(DOUBLE_DIFF_THREASH), and reports avg/var for both wall and internal
(device-compute) time, plus GFLOPS (2*NNZ/time) and nnz/s as in the
reference's spreadsheet reduction (SURVEY.md section 3.4).

The log schema mirrors the reference's structured-by-convention stdout
(#matrix header / config line / @computing per kernel / stats line —
scripts/parseLog.py:16-41), so our scripts/parse_log.py reducer carries over.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence

import jax
import numpy as np

from ..config import Config, DOUBLE_DIFF_THRESH
from ..formats.matrix import CSRMatrix, ELLMatrix
from ..ops import registry
from ..ops.oracle import serial_csr_spmv
from ..utils.compare import stats_avg_var, vectors_diff


@dataclasses.dataclass
class KernelResult:
    kernel: str
    impl: str
    fmt: str
    ok: bool
    max_abs_diff: float
    # wall per rep: dispatch + host sync around block_until_ready, logged as
    # wallDispatchAvg; it includes the fixed per-call cost, so kernel time
    # is internal_time_avg (the chain-slope measurement).
    time_avg: float
    time_var: float
    internal_time_avg: float  # device compute per rep (post-warmup)
    internal_time_var: float
    prepare_time: float  # upload + partitioning (once)
    gflops: float
    nnz_per_s: float
    reps: int
    error: Optional[str] = None
    deterministic: bool = True

    def stat_line(self) -> str:
        return (
            f"{self.kernel} wallDispatchAvg:{self.time_avg:.9e} "
            f"wallDispatchVar:{self.time_var:.3e} "
            f"internalTimeAvg:{self.internal_time_avg:.9e} "
            f"internalTimeVar:{self.internal_time_var:.3e} "
            f"prepTime:{self.prepare_time:.3e} GFLOPS:{self.gflops:.4f} "
            f"NNZs:{self.nnz_per_s:.4e} ok:{int(self.ok)} det:{int(self.deterministic)}"
        )


@dataclasses.dataclass
class MatrixReport:
    name: str
    m: int
    n: int
    nnz: int
    max_row_nz: int
    results: List[KernelResult] = dataclasses.field(default_factory=list)

    @property
    def all_ok(self) -> bool:
        return all(r.ok for r in self.results if r.error is None)


def run_kernel(
    spec: registry.KernelSpec,
    csr: CSRMatrix,
    ell: Optional[ELLMatrix],
    x: np.ndarray,
    cfg: Config,
    oracle: Optional[np.ndarray] = None,
    threshold: float = DOUBLE_DIFF_THRESH,
) -> KernelResult:
    """Time one kernel with the reference's protocol (testSpMVImplOMP /
    testSpMVImplCuda analog, SpMV_test.cu:67-145): N reps, each checked
    against the oracle; avg/var over reps."""
    import jax.numpy as jnp

    nnz = csr.nnz
    if oracle is None:
        oracle = serial_csr_spmv(csr, x)
    try:
        t0 = time.perf_counter()
        operands = spec.prepare(csr, ell, cfg)
        f = spec.jitted(operands)
        xj = jax.device_put(jnp.asarray(x, dtype=cfg.jnp_dtype))
        y = jax.block_until_ready(f(xj))  # compile + warmup
        prepare_time = time.perf_counter() - t0
    except Exception as e:  # registered-but-infeasible kernels keep the sweep going
        return KernelResult(
            spec.name, spec.impl, spec.fmt, False, float("inf"),
            0, 0, 0, 0, 0, 0, 0, cfg.avg_times_iteration, error=str(e)[:500],
        )

    diff = vectors_diff(np.asarray(y, dtype=np.float64)[: csr.shape[0]], oracle, threshold)
    # determinism check (the race-detection analog, SURVEY.md section 5: the
    # reference parked an OMP reduction race; a rerun that is not bitwise
    # identical means a nondeterministic reduction order, e.g. atomics)
    y2 = jax.block_until_ready(f(xj))
    deterministic = bool(np.array_equal(np.asarray(y), np.asarray(y2)))

    wall_times: List[float] = []
    for _ in range(cfg.avg_times_iteration):
        t0 = time.perf_counter()
        y = jax.block_until_ready(f(xj))
        wall_times.append(time.perf_counter() - t0)
    # internal time (the ElapsedInternal analog): slope between two on-device
    # dependency-chained rep counts, synced by scalar readback — cancels the
    # fixed per-call dispatch cost (see bench.py docstring)
    run = spec.run

    @jax.jit
    def chain(xv, steps):
        def body(i, xv):
            yv = run(operands, xv)
            return xv * (1.0 + jnp.sum(yv) * 1e-30)

        # steps is TRACED so every chain length shares one compilation
        return jax.lax.fori_loop(0, steps, body, xv, unroll=False)

    def timed_chain(steps):
        s = jnp.int32(steps)
        _ = float(jnp.sum(chain(xj, s)))  # compile/warm + sync
        best_t = float("inf")
        for _rep in range(cfg.avg_times_iteration):
            t1 = time.perf_counter()
            _ = float(jnp.sum(chain(xj, s)))
            best_t = min(best_t, time.perf_counter() - t1)
        return best_t

    lo_n = 3
    t_lo = timed_chain(lo_n)
    hi_n = lo_n + max(20, min(500, int(1.0 / max(t_lo / lo_n, 1e-6))))
    t_hi = timed_chain(hi_n)
    if t_hi - t_lo < 0.5:
        # step signal drowned in fixed-cost noise: escalate the chain until
        # the extra steps add ~1 s of device time. Bound by the measured
        # per-step UPPER bound t_lo/lo_n (includes all fixed costs) so noise
        # collapsing the slope can never schedule a multi-hour chain.
        slope1 = max((t_hi - t_lo) / (hi_n - lo_n), 1e-7)
        cap = int(10.0 / max(t_lo / lo_n, 1e-7))
        hi_n = lo_n + max(min(int(1.0 / slope1), cap), 20)
        t_hi = timed_chain(hi_n)
    chained = (t_hi - t_lo) / (hi_n - lo_n)
    if chained <= 0:  # still noise-bound: report the conservative bound
        chained = t_hi / hi_n
    internal_times = [chained] * cfg.avg_times_iteration

    t_avg, t_var = stats_avg_var(wall_times)
    it_avg, it_var = stats_avg_var(internal_times)
    # throughput from the slope-measured internal time only: wall time is
    # includes the fixed per-call cost and is not a kernel time
    best = it_avg
    return KernelResult(
        kernel=spec.name,
        impl=spec.impl,
        fmt=spec.fmt,
        ok=diff.ok,
        max_abs_diff=diff.max_abs_diff,
        time_avg=t_avg,
        time_var=t_var,
        internal_time_avg=it_avg,
        internal_time_var=it_var,
        prepare_time=prepare_time,
        gflops=2.0 * nnz / best / 1e9 if best > 0 else 0.0,
        nnz_per_s=nnz / best if best > 0 else 0.0,
        reps=cfg.avg_times_iteration,
        deterministic=deterministic,
    )


def run_all(
    csr: CSRMatrix,
    ell: Optional[ELLMatrix],
    x: np.ndarray,
    cfg: Config,
    kernels: Optional[Sequence[str]] = None,
    name: str = "matrix",
    threshold: float = DOUBLE_DIFF_THRESH,
) -> MatrixReport:
    """Run every registered kernel (or a subset) against one matrix.

    ELL kernels are skipped when ell is None (size-cap rejection path,
    reference SpMV_test.cu:173-178 tolerates MMtoELL failure)."""
    oracle = serial_csr_spmv(csr, x)
    specs = (
        [registry.get(k) for k in kernels]
        if kernels is not None
        else registry.all_kernels()
    )
    report = MatrixReport(
        name=name,
        m=csr.shape[0],
        n=csr.shape[1],
        nnz=csr.nnz,
        max_row_nz=csr.max_row_nz,
    )
    for spec in specs:
        if spec.fmt == "ell" and ell is None:
            continue
        report.results.append(
            run_kernel(spec, csr, ell, x, cfg, oracle=oracle, threshold=threshold)
        )
    return report


def format_log(report: MatrixReport, cfg: Config) -> str:
    """Structured log (the schema scripts/parse_log.py reduces to CSV)."""
    lines = [
        f"#matrix: {report.name} {report.m} {report.n} {report.nnz} {report.max_row_nz}",
        (
            f"#config: grid={cfg.grid_rows}x{cfg.grid_cols} dtype={cfg.dtype} "
            f"schedule={cfg.schedule} reps={cfg.avg_times_iteration} "
            f"rowLens={int(cfg.row_lens)} simd={int(cfg.simd_reduction)} "
            f"devices={len(jax.devices())} backend={jax.default_backend()}"
        ),
    ]
    for r in report.results:
        lines.append(f"@computing SpMV with func:{r.impl} {r.kernel}")
        if r.error is not None:
            lines.append(f"{r.kernel} ERROR: {(r.error.splitlines() or ['<no message>'])[0][:200]}")
        else:
            lines.append(r.stat_line())
    return "\n".join(lines)
