"""Where this repository's Pallas kernels run: the one backend rule.

No registered engine is a Pallas kernel; the DIA kernel candidates of
scripts/ab_kernels.py use this rule, so their tests run them in the
interpreter on the CPU and the A/B compiles them on the GPU."""
from __future__ import annotations

import jax


def interpret(backend: str | None = None) -> bool:
    """Whether a Pallas kernel runs in the interpreter.

    cpu: yes (the tests); gpu: no, the kernel compiles through Triton; any
    other backend has no kernel route here and raises."""
    backend = backend or jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas kernel route for backend {backend!r} (expected cpu or gpu)"
    )
