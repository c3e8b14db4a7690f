"""Iterative solvers composed over the SpMV engines.

The reference suite stops at the SpMV kernel benchmark; these cover how
SpMV is consumed in production (Krylov / power iterations) and prove the
property an accelerator design must have: a prepared format is a JAX
pytree, so an entire solve — matvec included — traces into ONE compiled
XLA program with `lax.while_loop` / `lax.fori_loop` control flow, static
shapes throughout, and zero host round trips per iteration. Works with
any engine `AutoSpMV` selects, in float32 or float64.

No reference-file counterpart (capability beyond the reference's scope);
the compiled-control-flow requirement is SURVEY.md's XLA-semantics rule.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

Matvec = Callable[[jax.Array], jax.Array]


class CGResult(NamedTuple):
    x: jax.Array
    iters: jax.Array  # iterations taken
    relres: jax.Array  # ||b - A x|| / ||b||


def conjugate_gradient(
    matvec: Matvec,
    b,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 200,
) -> CGResult:
    """Classic CG for symmetric positive-definite A, fully jit-compiled.

    ``matvec`` must be traceable (an ``AutoSpMV`` instance qualifies: its
    prepared operands are pytree constants of the trace). The loop is a
    ``lax.while_loop`` on (iter < maxiter) & (relres > tol) — one XLA
    program, no per-iteration dispatch."""
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    bnorm = jnp.sqrt(jnp.sum(b * b))

    def solve(b, x0):
        r0 = b - matvec(x0)
        p0 = r0
        rs0 = jnp.sum(r0 * r0)

        def cond(state):
            _x, _r, _p, rs, k = state
            return (k < maxiter) & (jnp.sqrt(rs) > tol * bnorm)

        def body(state):
            x, r, p, rs, k = state
            ap = matvec(p)
            alpha = rs / jnp.sum(p * ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = jnp.sum(r * r)
            p = r + (rs_new / rs) * p
            return (x, r, p, rs_new, k + 1)

        x, r, _p, rs, k = jax.lax.while_loop(
            cond, body, (x0, r0, p0, rs0, jnp.int32(0))
        )
        return x, k, jnp.sqrt(rs) / bnorm

    x, k, relres = jax.jit(solve)(b, x0)
    return CGResult(x=x, iters=k, relres=relres)


class PowerResult(NamedTuple):
    eigenvalue: jax.Array
    eigenvector: jax.Array


def power_iteration(
    matvec: Matvec, n: int, iters: int = 100, seed: int = 0,
    dtype=jnp.float32,
) -> PowerResult:
    """Dominant eigenpair by power iteration — one compiled fori_loop."""
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)

    def run(v0):
        def body(_i, v):
            w = matvec(v)
            return w / jnp.sqrt(jnp.sum(w * w))

        v = jax.lax.fori_loop(0, iters, body, v0 / jnp.sqrt(jnp.sum(v0 * v0)))
        lam = jnp.sum(v * matvec(v)) / jnp.sum(v * v)
        return lam, v

    lam, v = jax.jit(run)(v0)
    return PowerResult(eigenvalue=lam, eigenvector=v)
