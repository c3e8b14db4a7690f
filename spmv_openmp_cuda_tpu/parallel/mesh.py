"""Device mesh construction + multi-host initialization.

The reference has no distributed backend (SURVEY.md section 5: parallelism is
OMP shared memory + single-GPU PCIe copies); this module provides the layer
the build plan adds: jax.distributed init and a jax.sharding.Mesh with axes
  "rows" — output-row data parallelism (the row-block OMP/CUDA analogs)
  "cols" — contraction-axis parallelism (the 2D-tiles partial-sum analog).
The GPUs of one host are joined all to all by NVLink, so the mesh shape
follows the algorithm alone: (n, 1) for row sharding, (1, n) or (2, 2) for
contraction sharding.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS = "rows"
COLS = "cols"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed for multi-process runs (no-op for one
    process, which drives every GPU of its host)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    mesh_shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (rows, cols) mesh over available devices.

    Default: all devices on the rows axis (pure row data-parallelism), the
    configuration the reference's row-block kernels map to. Pass e.g. (2, 4)
    for 2D row x contraction sharding.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = (n, 1)
    assert mesh_shape[0] * mesh_shape[1] == n, (
        f"mesh {mesh_shape} != {n} devices"
    )
    arr = np.asarray(devices).reshape(mesh_shape)
    return Mesh(arr, (ROWS, COLS))


def row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ROWS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
