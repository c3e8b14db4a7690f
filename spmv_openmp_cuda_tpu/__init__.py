"""spmv_openmp_cuda_tpu — a JAX SpMV framework for NVIDIA GPUs.

JAX/XLA/Pallas implementation with the full capability surface of
the reference C/OpenMP/CUDA suite andreadiiorio/SpMV_openMP_CUDA (see
SURVEY.md): MatrixMarket ingestion, COO/CSR/ELL formats, the complete
partitioning-strategy kernel matrix, an oracle-checked benchmark harness,
corpus sweep + CSV tooling, and a multi-device sharded layer over
jax.sharding meshes.
"""
from .config import (
    AVG_TIMES_ITERATION,
    Config,
    DEFAULT_CONFIG,
    DOUBLE_DIFF_THRESH,
    ELL_MAX_ENTRIES,
    MAXRND,
)
from .formats.matrix import (
    COOMatrix,
    CSRMatrix,
    DeviceCSR,
    DeviceELL,
    ELLMatrix,
    device_csr,
    device_ell,
)
from .formats.convert import (
    EllSizeError,
    coo_to_csr,
    coo_to_ell,
    csr_to_coo,
    csr_to_dense,
    sort_coo,
)
from .io.mmio import mm_to_csr, mm_to_ell, read_coo, write_mtx


def __getattr__(name):
    # lazy engine exports: importing the package does not build the registry
    if name == "AutoSpMV":
        from .models.auto import AutoSpMV

        return AutoSpMV
    if name in ("prepare_dia", "DiaFillError"):
        from .formats import dia

        return getattr(dia, name)
    if name in ("save_prepared", "load_prepared"):
        from .formats import serialize

        return getattr(serialize, name)
    raise AttributeError(name)


__version__ = "0.1.0"
