"""Householder QR factorization (economy), jittable with static shapes.

Fixed-shape re-design of the reference's hand-rolled LINPACK-style QR
(reference: src/linalg/qr_decomposition.h:32-227): the column loop becomes a
``lax.fori_loop`` whose body applies each reflector with masked full-width
vector ops (no data-dependent shapes), so the whole factorization compiles to
a single XLA program. The packed representation matches the reference: Q is
held implicitly as Householder vectors in the lower trapezoid of ``packed``
(including the diagonal), R's strict upper triangle sits above it, and R's
diagonal lives in ``rdiag`` (= −σ_k).

For the IRLS hot path the library uses XLA's blocked ``jnp.linalg.qr``
(see solvers/irls.py) — this module is the explicit-reflector component with
``q()``/``r()``/``solve()`` parity (qr_decomposition.h:140-227).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax

from ..ops import blas


@jax.jit
def householder_factor(A: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Factor an m×n (m ≥ n) matrix; returns (packed, rdiag).

    Reference: qr_decomposition.h constructor (:94-137).
    """
    M, N = A.shape
    dtype = A.dtype
    rows = jnp.arange(M)

    def body(k, carry):
        QR, rdiag = carry
        rowmask = rows >= k
        x = jnp.where(rowmask, QR[:, k], 0)
        nrm = jnp.sqrt(jnp.sum(x * x))
        xk = QR[k, k]
        sigma = jnp.where(xk < 0, -nrm, nrm)  # qr_decomposition.h:113
        safe = nrm != 0
        denom = jnp.where(sigma == 0, jnp.array(1, dtype), sigma)
        v = jnp.where(safe, x / denom, jnp.array(0, dtype))
        v = v.at[k].add(jnp.where(safe, jnp.array(1, dtype), jnp.array(0, dtype)))

        # apply reflector to the remaining columns (j > k):
        # s = −(vᵀ QR)/v_k ; QR += v sᵀ   (qr_decomposition.h:119-132)
        vk = v[k]
        s = blas.xgemv(QR, v, trans=True)
        s = -s / jnp.where(vk == 0, jnp.array(1, dtype), vk)
        colmask = (jnp.arange(N) > k) & safe
        QR = QR + jnp.outer(v, jnp.where(colmask, s, 0))

        # pack the reflector into column k (rows ≥ k); untouched if unsafe
        newcol = jnp.where(rowmask & safe, v, QR[:, k])
        QR = QR.at[:, k].set(newcol)
        rdiag = rdiag.at[k].set(-sigma)
        return QR, rdiag

    return lax.fori_loop(0, N, body, (A, jnp.zeros((N,), dtype)))


@jax.jit
def q(packed: jnp.ndarray, rdiag: jnp.ndarray) -> jnp.ndarray:
    """Materialize the m×n economy Q. Reference: qr_decomposition.h:140-173."""
    M, N = packed.shape
    dtype = packed.dtype
    rows = jnp.arange(M)
    cols = jnp.arange(N)

    def body(t, Q):
        k = N - 1 - t
        v = jnp.where(rows >= k, packed[:, k], 0)
        # initialize column k to e_k
        ek = (rows == k).astype(dtype)
        Q = Q.at[:, k].set(ek)
        vk = v[k]
        live = vk != 0
        s = blas.xgemv(Q, v, trans=True)
        s = -s / jnp.where(live, vk, jnp.array(1, dtype))
        colmask = (cols >= k) & live
        return Q + jnp.outer(v, jnp.where(colmask, s, 0))

    return lax.fori_loop(0, N, body, jnp.zeros((M, N), dtype))


@jax.jit
def r(packed: jnp.ndarray, rdiag: jnp.ndarray) -> jnp.ndarray:
    """Materialize the n×n R. Reference: qr_decomposition.h:176-190."""
    N = packed.shape[1]
    upper = jnp.triu(packed[:N, :N], 1)
    return upper + jnp.diag(rdiag)


@jax.jit
def solve(packed: jnp.ndarray, rdiag: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Least-squares solve min‖Ax − b‖₂ from the packed factorization.

    Reference: qr_decomposition.h:193-227 (implicit Qᵀb, then
    back-substitution against R).
    """
    M, N = packed.shape
    dtype = packed.dtype
    rows = jnp.arange(M)

    def apply_qt(n, s):
        v = jnp.where(rows >= n, packed[:, n], 0)
        vn = v[n]
        w = -blas.xdot(v, s) / jnp.where(vn == 0, jnp.array(1, dtype), vn)
        return s + jnp.where(vn == 0, 0, w) * v

    s = lax.fori_loop(0, N, apply_qt, b.astype(dtype))
    R = r(packed, rdiag)
    return blas.xtrsm(R, s[:N], lower=False)


class QRDecomposition:
    """Construct-once QR over a device-resident matrix.

    Mirrors the reference's amortized-state API shape: the IRLS solver
    computes this once at construction and reuses it across solves
    (reference: src/lib.cpp:51-57).
    """

    def __init__(self, A: jnp.ndarray):
        M, N = A.shape
        if M < N:
            raise ValueError(
                "QR requires m >= n (underdetermined systems not supported); "
                f"got {M}x{N}"
            )
        self.packed, self.rdiag = householder_factor(A)

    def q(self) -> jnp.ndarray:
        return q(self.packed, self.rdiag)

    def r(self) -> jnp.ndarray:
        return r(self.packed, self.rdiag)

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        return solve(self.packed, self.rdiag, b)
