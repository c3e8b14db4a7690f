"""Kernel registry: the uniform ABI + enumeration tables.

Analog of the reference's function-pointer registries (SpmvCSRFuncs /
SpmvELLFuncs / SpmvCUDA_*Funcs, reference src/include/SpMV.h:130-159) and the
COMPUTE_MODE string dispatch (SpMV.h:27-59, main.cu:103-139).

Uniform ABI: every kernel is described by a KernelSpec whose
  prepare(csr, ell, cfg)  -> operands pytree (device upload + partitioning)
  run(operands, x)        -> y            (jittable; cfg baked in at prepare)
split mirrors the reference's separation of host-side setup (upload /
partitioning) from the timed kernel body (ElapsedInternal).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..formats.matrix import (
    CSRMatrix,
    ELLMatrix,
    DeviceCSR,
    DeviceELL,
    device_csr,
    device_ell,
)
from ..formats.convert import csr_to_coo, coo_to_ell
from ..partition.partitioners import cols_partitioning
from . import spmv_xla


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered compute mode."""

    name: str  # compute-mode string (CLI + harness id)
    fmt: str  # "csr" | "ell" — which host format it needs
    impl: str  # "xla": every registered engine compiles through XLA
    prepare: Callable  # (csr, ell, cfg) -> operands
    run: Callable  # (operands, x) -> y ; jittable
    doc: str = ""
    f64: bool = True  # accepts float64 (False: a bf16-storage mode)

    def jitted(self, operands):
        """Return a jitted closure over prepared operands."""
        run = self.run

        @jax.jit
        def f(x):
            return run(operands, x)

        return f


_REGISTRY: Dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    assert spec.name not in _REGISTRY, f"duplicate kernel {spec.name}"
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown compute mode {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def all_kernels(fmt: Optional[str] = None, impl: Optional[str] = None) -> List[KernelSpec]:
    out = [
        s
        for s in _REGISTRY.values()
        if (fmt is None or s.fmt == fmt) and (impl is None or s.impl == impl)
    ]
    return out


def names() -> List[str]:
    return list(_REGISTRY)


# ---------------------------------------------------------------------------
# prepare helpers
# ---------------------------------------------------------------------------


def _prep_csr(csr: CSRMatrix, ell: ELLMatrix, cfg: Config) -> DeviceCSR:
    return device_csr(csr, dtype=cfg.jnp_dtype)


def _prep_ell(csr: CSRMatrix, ell: ELLMatrix, cfg: Config) -> DeviceELL:
    return device_ell(ell, dtype=cfg.jnp_dtype)


def _prep_ell_t(csr: CSRMatrix, ell: ELLMatrix, cfg: Config) -> DeviceELL:
    return device_ell(ell, dtype=cfg.jnp_dtype, transposed=True)


def _prep_csr_parts(csr: CSRMatrix, ell: ELLMatrix, cfg: Config):
    parts = cols_partitioning(csr, cfg.grid_cols)
    return tuple(device_csr(p, dtype=cfg.jnp_dtype) for p in parts)


# ---------------------------------------------------------------------------
# registrations — OpenMP strategy matrix analogs (XLA-lowered)
# ---------------------------------------------------------------------------


def _register_xla(cfg_defaults: Config = Config()) -> None:
    register(
        KernelSpec(
            name="CSR_ROWS",
            fmt="csr",
            impl="xla",
            prepare=_prep_csr,
            run=lambda mat, x: spmv_xla.csr_rows(mat, x),
            doc="row-parallel CSR: gather + sorted segment-sum "
            "(spmvRowsBasicCSR analog, SpMV_CSR_OMP.c:34-63)",
        )
    )
    def _prep_csr_groups(csr, ell, cfg):
        mat = _prep_csr(csr, ell, cfg)
        b = max(int(cfg.grid_rows), 1)
        rpb = max(-(-csr.shape[0] // b), 1)
        bounds = [min(i * rpb, csr.shape[0]) for i in range(b + 1)]
        starts = csr.indptr[np.asarray(bounds, dtype=np.int64)]
        max_ext = max(int(np.diff(starts).max()), 1)
        return (mat, jnp.asarray(starts, dtype=jnp.int32), rpb, max_ext)

    register(
        KernelSpec(
            name="CSR_ROWS_GROUPS",
            fmt="csr",
            impl="xla",
            prepare=_prep_csr_groups,
            run=lambda ops, x: spmv_xla.csr_rows_groups(
                ops[0], x, ops[1], ops[2], ops[3]
            ),
            doc="fair row-block CSR, a real blocked schedule: grid_rows "
            "blocks each dynamic-slice their nnz range and reduce locally "
            "under lax.map (spmvRowsBlocksCSR analog, SpMV_CSR_OMP.c:65-99); "
            "the same block decomposition is the sharding unit",
        )
    )

    def _prep_csr_tiles(csr, ell, cfg):
        return (_prep_csr(csr, ell, cfg), cfg.grid_cols)

    register(
        KernelSpec(
            name="CSR_TILES",
            fmt="csr",
            impl="xla",
            prepare=_prep_csr_tiles,
            run=lambda ops, x: spmv_xla.csr_tiles(ops[0], x, ops[1]),
            doc="2D tiles via column-range bucketing, partial sums + reduce "
            "(spmvTilesCSR analog, SpMV_CSR_OMP.c:101-162)",
        )
    )
    register(
        KernelSpec(
            name="CSR_TILES_ALLOCD",
            fmt="csr",
            impl="xla",
            prepare=_prep_csr_parts,
            run=lambda parts, x: spmv_xla.csr_tiles_allocd(parts, x),
            doc="2D tiles over separately-allocated column-partition CSRs "
            "(spmvTilesAllocdCSR analog, SpMV_CSR_OMP.c:165-226)",
        )
    )

    def _mk_ell_run(row_lens: bool, simd: bool):
        return lambda mat, x: spmv_xla.ell_rows(mat, x, row_lens=row_lens, simd=simd)

    register(
        KernelSpec(
            name="ELL_ROWS",
            fmt="ell",
            impl="xla",
            prepare=_prep_ell,
            run=_mk_ell_run(True, True),
            doc="row-parallel ELL over lane-aligned slabs "
            "(spmvRowsBasicELL analog, SpMV_ELL_OMP.c:33-67)",
        )
    )
    def _prep_ell_groups(csr, ell, cfg):
        return (_prep_ell(csr, ell, cfg), max(int(cfg.grid_rows), 1))

    register(
        KernelSpec(
            name="ELL_ROWS_GROUPS",
            fmt="ell",
            impl="xla",
            prepare=_prep_ell_groups,
            run=lambda ops, x: spmv_xla.ell_rows_groups(
                ops[0], x, grid_rows=ops[1]
            ),
            doc="fair row-block ELL, a real blocked schedule: grid_rows "
            "slab blocks reduced block-by-block under lax.scan "
            "(spmvRowsBlocksELL analog, SpMV_ELL_OMP.c:69-108)",
        )
    )

    def _prep_ell_tiles(csr, ell, cfg):
        return (_prep_ell(csr, ell, cfg), cfg.grid_cols)

    register(
        KernelSpec(
            name="ELL_TILES",
            fmt="ell",
            impl="xla",
            prepare=_prep_ell_tiles,
            run=lambda ops, x: spmv_xla.ell_tiles(ops[0], x, ops[1]),
            doc="2D ELL tiles splitting the padded width "
            "(spmvTilesELL analog, SpMV_ELL_OMP.c:110-174)",
        )
    )
    register(
        KernelSpec(
            name="ELL_ROWS_T",
            fmt="ell",
            impl="xla",
            prepare=_prep_ell_t,
            run=lambda mat, x: spmv_xla.ell_rows_transposed(mat, x),
            doc="transposed-slab ELL, rows on the contiguous axis — coalescing "
            "analog (cudaSpMVRowsELL + ellTranspose, SpMV_CUDA.cu:79-96)",
        )
    )
    # SIMD/scalar-order reduction variants (SIMD_ROWS_REDUCTION toggle
    # analog, config.h:92-98) — registered as their own modes so the harness
    # can A/B them like the reference's separate build configs.
    register(
        KernelSpec(
            name="ELL_ROWS_NOSIMD",
            fmt="ell",
            impl="xla",
            prepare=_prep_ell,
            run=_mk_ell_run(True, False),
            doc="ELL rows with strict sequential-order width reduction "
            "(SIMD_ROWS_REDUCTION=FALSE analog)",
        )
    )
    register(
        KernelSpec(
            name="ELL_ROWS_NORL",
            fmt="ell",
            impl="xla",
            prepare=_prep_ell,
            run=_mk_ell_run(False, True),
            doc="ELL rows without row-lens masking (NO_ROWLENS build analog)",
        )
    )


def _register_storage_formats() -> None:
    """Storage engines beyond the reference's CSR/ELL pair: the row-binned
    jagged-ELL ("binned CSR") and the DIA zero-gather path for
    diagonal-concentrated matrices."""
    from ..formats.binned import binned_spmv, prepare_binned_csr
    from ..formats.dia import dia_spmv, prepare_dia

    register(
        KernelSpec(
            name="CSR_ROWS_BINNED",
            fmt="csr",
            impl="xla",
            prepare=lambda csr, ell, cfg: prepare_binned_csr(csr, dtype=cfg.jnp_dtype),
            run=binned_spmv,
            doc="row-binned width-class slabs — CSR memory economics with "
            "dense per-class reduces; the dynamic-scheduling/row-binning "
            "analog (ompChunksDivide.h) as a storage transform",
        )
    )
    register(
        KernelSpec(
            name="DIA_ROWS",
            fmt="csr",
            impl="xla",
            prepare=lambda csr, ell, cfg: prepare_dia(csr, dtype=cfg.jnp_dtype),
            run=dia_spmv,
            doc="diagonal storage: y = sum_d diag_d * shift(x, d); no indices, "
            "no gather — speed-of-light for banded matrices (raises "
            "DiaFillError beyond a 3x padding budget, the ELL-cap analog)",
        )
    )
    register(
        KernelSpec(
            name="DIA_BF16",
            fmt="csr",
            impl="xla",
            prepare=lambda csr, ell, cfg: prepare_dia(csr, dtype=jnp.bfloat16),
            run=dia_spmv,
            doc="DIA_ROWS with a bf16 slab (f32 accumulate): half the slab "
            "bytes on the bandwidth-bound banded path",
            f64=False,
        )
    )


_register_xla()
_register_storage_formats()
