"""Sensing-matrix operators — the seam between solver math and data layout.

The homotopy loop only touches A through four products (reference call
stack: SURVEY.md §3.2 / src/solvers/homotopy-cpu.cpp):
  * matvec        p = A d            (find_max_gamma :116)
  * rmatvec       c = Aᵀ r           (residual_vector :97, find_max_gamma :120)
  * column        v = A e_j          (inverse insert, :180-181)
  * gram column   g = AᵀA e_j, vᵀv   (online_inverse insert :217-218)

Abstracting these lets the identical while_loop run over
  * a dense single-device matrix (DenseOperator), or
  * a row-shard of A inside ``shard_map``, where every n-sized product ends
    with a ``psum`` over the row axis (RowShardedOperator) — the mesh
    replacement for the reference's single-address-space BLAS calls
    (SURVEY.md §2.4: partial correlations per shard + one allreduce).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from . import blas


class DenseOperator(NamedTuple):
    """Plain on-device dense sensing matrix.

    ``G`` optionally carries the precomputed Gram matrix AᵀA (n×n). The
    reference recomputes Gram *columns* with gemvs every active-set insert
    (homotopy-cpu.cpp:180-181 → online_inverse insert) because memory was
    the constraint on CPU; on the device, memory is large and bandwidth is the
    constraint, so paying 2mn² FLOPs once at construction turns every
    insert (and, in the sparse-q fast path, the whole γ-scan product
    q = AᵀA d) into an O(n·k) gather instead of an O(mn) pass over A.
    """
    A: jnp.ndarray
    G: jnp.ndarray | None = None

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def has_gram(self):
        return self.G is not None

    def matvec(self, x):
        return blas.xgemv(self.A, x)

    def matvec_sparse(self, x, indices, vals=None):
        """A x for x supported on ``indices`` (sentinel-n slots gather 0) —
        an (m, k_max) column gather + small matmul instead of a full pass.
        ``vals`` (slot-ordered values x[indices]) skips the dense gather
        when the caller already holds them (the OMP loop's coefficients
        live in slot space — no O(n) scatter/regather per iteration)."""
        cols = jnp.take(self.A, indices, axis=1, mode="fill", fill_value=0)
        if vals is None:
            vals = jnp.take(x, indices, mode="fill", fill_value=0)
        return blas.xgemv(cols, vals)

    def rmatvec(self, u):
        return blas.xgemv(self.A, u, trans=True)

    def column(self, j):
        return self.A[:, j]

    def gram_column(self, j):
        """((AᵀA)[:, j], ‖A e_j‖²)."""
        if self.G is not None:
            return self.G[:, j], self.G[j, j]
        v = self.column(j)
        return self.rmatvec(v), blas.xdot(v, v)

    def gram_matvec_sparse(self, d, indices, vals=None):
        """q = AᵀA d for d supported on ``indices`` via Gram-column gather —
        O(n·k) bytes, no pass over A. Requires a precomputed ``G``.
        ``vals`` = slot-ordered d[indices], skipping the dense gather."""
        cols = jnp.take(self.G, indices, axis=1, mode="fill", fill_value=0)
        if vals is None:
            vals = jnp.take(d, indices, mode="fill", fill_value=0)
        return blas.xgemv(cols, vals)

    def gram_gathered(self, col, slots):
        """(u1, vtv) with u1[i] = (AᵀA)[slots[i], col] (sentinel slots → 0)
        and vtv = (AᵀA)[col, col]. With a precomputed Gram this is one
        contiguous row lookup (G is symmetric: G[:, col] = G[col, :]) plus
        a k_max-element gather from that row — far cheaper than a
        2-d point gather into the full n×n table. Without G: one
        Gram-column product followed by the same gather."""
        if self.G is not None:
            row = jnp.take(self.G, col, axis=0)
            u1 = jnp.take(row, slots, mode="fill", fill_value=0)
            return u1, row[col]
        g, vtv = self.gram_column(col)
        return jnp.take(g, slots, mode="fill", fill_value=0), vtv

    def gram_weighted(self, w):
        """Aᵀ(A ∘ w) — the IRLS Newton Gram matrix (irls-cpu.cpp:47-48)."""
        return blas.xgemm(self.A, self.A * w, trans_a=True)

    def mdot(self, u, v):
        """Inner product of two m-dimension vectors (signals/residuals) —
        sharded operators psum this over the row axis."""
        return blas.xdot(u, v)


class ColShardedOperator(NamedTuple):
    """A column-shard of A inside shard_map: A_local is (m, n_local).

    The natural layout for the underdetermined (m ≪ n) regime served by
    CG-IRLS (solvers/irls_cg.py): x, the weights, and Aᵀu stay sharded
    along n, while m-sized quantities (y, the CG iterates z/r/p) are
    replicated — so the only collective is one ``psum`` per matvec
    A(D∘Aᵀz), i.e. one per CG step. The reference has no distributed
    analog (SURVEY.md §2.4: single address space)."""
    A_local: jnp.ndarray
    axis: str

    @property
    def dtype(self):
        return self.A_local.dtype

    def matvec(self, x_local):
        return lax.psum(blas.xgemv(self.A_local, x_local), self.axis)

    def rmatvec(self, u):
        return blas.xgemv(self.A_local, u, trans=True)  # stays col-sharded


class RowShardedOperator(NamedTuple):
    """A row-shard of A inside shard_map: A_local is (m_local, n); every
    reduction over rows finishes with a psum over ``axis``.

    The m-dimension quantities (p = A d, residual r) stay sharded — they are
    only ever consumed by a following rmatvec — so exactly one collective
    (the psum of the n-sized correlation) crosses devices per product, as in the
    SURVEY §2.4 target design.
    """
    A_local: jnp.ndarray
    axis: str
    G: jnp.ndarray | None = None  # replicated AᵀA (psum'd at construction)
    # Correlation split factor (collective-overlap experiment): with
    # split=s, rmatvec issues s independent half-width psums, exposing
    # each collective for overlap with the next block's local gemv (the
    # BASELINE.json north-star "psum overlapped with next matvec tile").
    # split=1 is the default single-psum design.
    split: int = 1

    @property
    def shape(self):
        # logical (global) shape is not recoverable here; callers inside
        # shard_map use n = A_local.shape[1] which is global.
        return self.A_local.shape

    @property
    def dtype(self):
        return self.A_local.dtype

    @property
    def has_gram(self):
        return self.G is not None

    def matvec(self, x):
        return blas.xgemv(self.A_local, x)  # stays row-sharded

    def matvec_sparse(self, x, indices, vals=None):
        """Local-shard rows of A x for k-sparse x — column gather over the
        local shard; the result stays row-sharded like ``matvec``.
        ``vals`` = slot-ordered x[indices], skipping the dense gather."""
        cols = jnp.take(self.A_local, indices, axis=1, mode="fill",
                        fill_value=0)
        if vals is None:
            vals = jnp.take(x, indices, mode="fill", fill_value=0)
        return blas.xgemv(cols, vals)

    def gram_matvec_sparse(self, d, indices, vals=None):
        """q = AᵀA d via replicated-Gram gather — zero collectives."""
        cols = jnp.take(self.G, indices, axis=1, mode="fill", fill_value=0)
        if vals is None:
            vals = jnp.take(d, indices, mode="fill", fill_value=0)
        return blas.xgemv(cols, vals)

    def gram_gathered(self, col, slots):
        """(u1, vtv) as in DenseOperator.gram_gathered; one psum'd Gram
        column when no replicated G is held."""
        if self.G is not None:
            row = jnp.take(self.G, col, axis=0)
            u1 = jnp.take(row, slots, mode="fill", fill_value=0)
            return u1, row[col]
        g, vtv = self.gram_column(col)
        return jnp.take(g, slots, mode="fill", fill_value=0), vtv

    def rmatvec(self, u_local):
        if self.split <= 1:
            return lax.psum(blas.xgemv(self.A_local, u_local, trans=True),
                            self.axis)
        # pipelined variant: one psum per column block, so the collective
        # for block i can run while block i+1's gemv runs
        n = self.A_local.shape[1]
        step = -(-n // self.split)
        parts = [
            lax.psum(blas.xgemv(self.A_local[:, i:i + step], u_local,
                                trans=True), self.axis)
            for i in range(0, n, step)
        ]
        return jnp.concatenate(parts)

    def column(self, j):
        return self.A_local[:, j]  # local shard of the column

    def gram_column(self, j):
        if self.G is not None:
            return self.G[:, j], self.G[j, j]
        v = self.column(j)
        g = lax.psum(blas.xgemv(self.A_local, v, trans=True), self.axis)
        vtv = lax.psum(blas.xdot(v, v), self.axis)
        return g, vtv

    def gram_weighted(self, w):
        return lax.psum(
            blas.xgemm(self.A_local, self.A_local * w, trans_a=True),
            self.axis)

    def mdot(self, u_local, v_local):
        """Inner product of row-sharded m-vectors: local dot + one psum."""
        return lax.psum(blas.xdot(u_local, v_local), self.axis)
