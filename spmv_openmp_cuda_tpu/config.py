"""Run configuration for the SpMV framework.

Analog of the reference's three-tier config system
(reference: src/include/config.h:21-32 CONFIG struct, compile-time macros
config.h:38-119, and env overrides utils.c:279-302): everything is collapsed
into one dataclass with environment-variable overrides, as SURVEY.md section 5
prescribes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Constants mirroring the reference's compile-time configuration
# (reference: src/include/config.h:69-115). Values are behavioral parity
# targets, not copied code.
# ---------------------------------------------------------------------------

#: Max padded (2 * M * max_row_nz) entries allowed for an ELL materialization
#: (reference: config.h:69-70 ELL_MAX_ENTRIES = 6 << 27, parser.c:223-232).
ELL_MAX_ENTRIES: int = 6 << 27

#: Absolute elementwise tolerance for oracle comparison
#: (reference: config.h:113 DOUBLE_DIFF_THREASH).
DOUBLE_DIFF_THRESH: float = 7e-4

#: Random vectors are capped at this magnitude so accumulation-order FP error
#: stays within tolerance (reference: config.h:115 MAXRND).
MAXRND: float = 3e-5

#: Default number of timed repetitions per kernel in the bench harness
#: (reference: config.h:83-85 AVG_TIMES_ITERATION).
AVG_TIMES_ITERATION: int = 5

#: Fair chunk folding factor for the dynamic-schedule analog
#: (reference: config.h:87-89 FAIR_CHUNKS_FOLDING).
FAIR_CHUNKS_FOLDING: int = 4

#: Default random vector size when no matrix dictates one
#: (reference: config.h:76 RNDVECTORSIZE).
RNDVECTORSIZE: int = 100_000

#: Minor-axis alignment of the device slabs: ELL widths, DIA rows and
#: binned classes pad to a multiple of this (the cudaMallocPitch analog,
#: reference: cudaUtils.cu:56-98).
LANE: int = 128

#: Second-axis alignment of the device slabs.
SUBLANE: int = 8

_DTYPES = {
    "float32": jnp.float32,
    "float64": jnp.float64,
    "bfloat16": jnp.bfloat16,
}


@dataclasses.dataclass
class Config:
    """One run's configuration (reference CONFIG struct analog).

    grid_rows/grid_cols mirror the reference's 2D tiling grid
    (reference: config.h:22-23, default 8x8 at main.cu:57-60).
    """

    grid_rows: int = 8
    grid_cols: int = 8
    #: Compute dtype on device. float64 is the reference's arithmetic and
    #: runs natively; float32 is the performance default.
    dtype: str = "float32"
    #: Timed repetitions for avg/var stats.
    avg_times_iteration: int = AVG_TIMES_ITERATION
    #: Scheduling analog: "static" keeps natural row order, "dynamic" applies
    #: row binning/reordering by length (reference ompChunksDivide.h analog).
    schedule: str = "static"
    chunk_folding: int = FAIR_CHUNKS_FOLDING
    #: Use per-row lengths for early termination in ELL kernels
    #: (reference ROWLENS macro, config.h:64-67).
    row_lens: bool = True
    #: Vectorized inner reduction toggle (reference SIMD_ROWS_REDUCTION,
    #: config.h:92-98). Off forces a scan-based scalar-order reduction.
    simd_reduction: bool = True
    #: Cap on padded ELL entries; conversions raise EllSizeError beyond it.
    ell_max_entries: int = ELL_MAX_ENTRIES
    #: Dump directory for output vectors (reference TMPDIR, config.h:116-119).
    tmpdir: str = "/tmp"
    seed: int = 0

    def __post_init__(self):
        if self.dtype == "float64":
            # double precision (the reference's native dtype) needs the x64
            # flag or jnp silently degrades to f32.
            # NOTE: jax_enable_x64 is process-global and sticky by JAX
            # design — enable it once at config construction, not lazily
            # from a property getter mid-run.
            import jax

            jax.config.update("jax_enable_x64", True)

    @property
    def jnp_dtype(self):
        return _DTYPES[self.dtype]

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Build a Config applying env-var overrides.

        Mirrors the reference's getConfig() env reads (utils.c:279-302:
        GRID_ROWS, GRID_COLS) plus the OMP_SCHEDULE ICV analog.
        """
        cfg = cls(**overrides)
        env_map = {
            "GRID_ROWS": ("grid_rows", int),
            "GRID_COLS": ("grid_cols", int),
            "SPMV_DTYPE": ("dtype", str),
            "AVG_TIMES_ITERATION": ("avg_times_iteration", int),
            "SPMV_SCHEDULE": ("schedule", str),
            "SPMV_ROWLENS": ("row_lens", lambda s: s not in ("0", "false", "False")),
            "SPMV_SIMD": ("simd_reduction", lambda s: s not in ("0", "false", "False")),
            "TMPDIR": ("tmpdir", str),
        }
        for env, (field, conv) in env_map.items():
            val = os.environ.get(env)
            if val is not None:
                setattr(cfg, field, conv(val))
        return cfg


DEFAULT_CONFIG = Config()
