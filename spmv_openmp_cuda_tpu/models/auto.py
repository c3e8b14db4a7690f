"""High-level user-facing SpMV model with automatic format selection.

The reference makes the user pick a COMPUTE_MODE per matrix and measures all
of them to find the winner (its report's central exercise). This model
encodes those findings as a structure-driven selection policy — the analog of
the reference's conclusions (relazione.tex: ELL wins when padding is bounded,
CSR when rows are skewed, transposed layouts when coalescing pays) — over
the registry's engines:

- diagonal-concentrated -> DIA (no indices, no gather)
- everything else -> row-binned CSR (width-class slabs; on one H100 it is
  the fastest or tied general engine on every proxy, bounded-padding FEM
  and power-law graphs alike — PERF.md "Kernel decisions")
- transposed ELL stays available as an explicit format

The CLI's AUTO mode uses the same policy (AUTO_MODES).

Usage:
    model = AutoSpMV.from_file("matrix.mtx")         # or from_coo / from_csr
    y = model(x)                                      # jitted y = A @ x
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..formats.convert import EllSizeError, coo_to_csr, coo_to_ell, csr_to_coo
from ..formats.dia import DiaFillError
from ..formats.matrix import COOMatrix, CSRMatrix
from ..ops import registry

#: format -> registry mode; float64 runs the same modes natively
AUTO_MODES = {
    "dia": "DIA_ROWS",
    "ell_t": "ELL_ROWS_T",
    "binned": "CSR_ROWS_BINNED",
}


def select_format(csr: CSRMatrix, dia_fill_cap: float = 2.0) -> str:
    """Pick a storage engine from matrix structure (cheap, host-side):
    DIA if the distinct-diagonal count keeps fill under dia_fill_cap x nnz,
    row-binned CSR otherwise."""
    m, n = csr.shape
    nnz = max(csr.nnz, 1)
    # DIA needs distinct-offset count <= dia_fill_cap*nnz/m; for huge
    # matrices first reject cheaply from a sample (a sample undercounts
    # distinct offsets, so exceeding the cap on the sample is conclusive)
    max_offs = int(dia_fill_cap * nnz / max(m, 1))
    if csr.nnz > 4_000_000:
        idx = np.linspace(0, csr.nnz - 1, 200_000).astype(np.int64)
        rows_s = np.searchsorted(csr.indptr, idx, side="right") - 1
        if np.unique(csr.indices[idx] - rows_s).shape[0] > max_offs:
            return "binned"
    if np.unique(csr.indices - csr.row_ids()).shape[0] <= max_offs:
        return "dia"
    return "binned"


def prepare_format(csr: CSRMatrix, fmt: str, cfg: Config):
    """(format, registry spec, operands), falling back to row-binned CSR
    when the structural guess trips a format's exact prepare-time cap."""
    if fmt not in AUTO_MODES:
        raise ValueError(
            f"unknown format {fmt!r}; expected auto or one of "
            f"{', '.join(AUTO_MODES)}"
        )
    spec = registry.get(AUTO_MODES[fmt])
    try:
        ell = None
        if spec.fmt == "ell":
            ell = coo_to_ell(csr_to_coo(csr), max_entries=cfg.ell_max_entries)
        return fmt, spec, spec.prepare(csr, ell, cfg)
    except (DiaFillError, EllSizeError):
        spec = registry.get(AUTO_MODES["binned"])
        return "binned", spec, spec.prepare(csr, None, cfg)


@dataclasses.dataclass
class AutoSpMV:
    """A prepared, jitted SpMV operator y = A @ x."""

    format: str
    shape: tuple
    nnz: int
    _fn: Callable
    _operands: object
    dtype: str = "float32"
    mode: str = ""

    @classmethod
    def from_csr(
        cls,
        csr: CSRMatrix,
        cfg: Optional[Config] = None,
        format: str = "auto",
    ) -> "AutoSpMV":
        cfg = cfg or Config()
        fmt = select_format(csr) if format == "auto" else format
        fmt, spec, ops = prepare_format(csr, fmt, cfg)
        jitted = jax.jit(spec.run)
        m = csr.shape[0]

        def fn(x):
            return jitted(ops, jnp.asarray(x, dtype=cfg.jnp_dtype))[:m]

        return cls(
            format=fmt,
            shape=csr.shape,
            nnz=csr.nnz,
            _fn=fn,
            _operands=ops,
            dtype=cfg.dtype,
            mode=spec.name,
        )

    @classmethod
    def from_coo(cls, coo: COOMatrix, **kw) -> "AutoSpMV":
        return cls.from_csr(coo_to_csr(coo), **kw)

    @classmethod
    def from_file(cls, path: str, **kw) -> "AutoSpMV":
        from ..io.mmio import read_coo

        return cls.from_coo(read_coo(path), **kw)

    def __call__(self, x) -> jax.Array:
        return self._fn(x)
