"""Cholesky factorization with SPD detection.

The reference implements a left-looking Cholesky that records non-SPD inputs
via a flag instead of erroring (reference:
src/linalg/cholesky_decomposition.h:28-113, pivot check at :80-83), which the
IRLS solver uses to degrade gracefully with ``spd_failure``
(src/solvers/irls-cpu.cpp:50-51,95-97).

On the device the factorization itself is XLA's blocked ``cholesky`` lowering (the
fast path); SPD detection reproduces the reference's pivot criterion: the
factorization is declared non-SPD when any pivot √a_jj ≤ machine eps. A
pivot that goes *negative* yields NaNs from XLA's cholesky; we flag that as
non-SPD as well (the sane strengthening of the reference's check — its NaN
pivots compare false against eps and slip through).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import blas


def cholesky_spd(A: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Return (L, isspd) with A ≈ L Lᵀ, L lower-triangular.

    Safe under jit: always returns a factor; ``isspd`` is a traced bool.
    """
    eps = jnp.finfo(A.dtype).eps
    L = jnp.linalg.cholesky(A)
    diag = jnp.diagonal(L)
    isspd = jnp.all(jnp.isfinite(L)) & jnp.all(diag > eps)
    return L, isspd


def cholesky_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given A = L Lᵀ via two triangular solves.

    Reference: cholesky_decomposition.h:94-103 (two xtrsv calls).
    """
    y = blas.xtrsv(L, b, lower=True, trans=False)
    return blas.xtrsv(L, y, lower=True, trans=True)
