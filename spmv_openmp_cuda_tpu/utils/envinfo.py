"""Runtime environment introspection.

Analog of the reference's OMP ICV introspection (ompGetICV.c:23-73:
ompGetRuntimeSchedule / ompGetAllICV printed for logging) and the standalone
env-check programs (test/ompChecks/*.cpp): report the JAX backend, device
inventory, the card's name and power limit, and the config env overrides in
effect.
"""
from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional


def env_overrides() -> Dict[str, str]:
    keys = [
        "GRID_ROWS", "GRID_COLS", "SPMV_DTYPE", "AVG_TIMES_ITERATION",
        "SPMV_SCHEDULE", "SPMV_ROWLENS", "SPMV_SIMD", "TMPDIR",
        "JAX_PLATFORMS", "XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR",
        "XLA_PYTHON_CLIENT_MEM_FRACTION",
    ]
    return {k: os.environ[k] for k in keys if k in os.environ}


def gpu_name_power() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` as it prints it (one line
    per card), or None where nvidia-smi is missing or fails. Times measured
    on a card are only comparable at the same power limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def runtime_info() -> Dict[str, object]:
    import jax

    devs = jax.devices()
    info: Dict[str, object] = {
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "device_count": len(devs),
        "devices": [str(d) for d in devs],
        "device_kind": devs[0].device_kind,
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "env_overrides": env_overrides(),
    }
    if info["backend"] == "gpu":
        info["gpu_name_power_limit"] = gpu_name_power()
        info["memory_bytes_limit"] = (devs[0].memory_stats() or {}).get(
            "bytes_limit"
        )
    return info


def format_info() -> str:
    info = runtime_info()
    lines: List[str] = [f"{k}: {v}" for k, v in info.items()]
    return "\n".join(lines)


if __name__ == "__main__":
    print(format_info())
