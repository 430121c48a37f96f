"""Masked online column inverse — (A_ΓᵀA_Γ)⁻¹ maintained on a padded buffer.

The reference maintains the inverse of the active-set Gram matrix as columns
enter/leave Γ by growing/shrinking a heap buffer with row/column rotations
(reference: src/linalg/online_inverse.h:35-301, math in
docs/algorithms/online-matrix-inverse/src.tex). On the device the buffer is a fixed
``(capacity, capacity)`` array: the live k×k inverse occupies the top-left
block in *rank order* (ranks = positions in the ascending active-index
vector), everything outside is zero, and the reference's ``square_permute``
/ ``insert_last_rowcol`` / ``erase_last_rowcol`` buffer surgery becomes a
single permutation-gather — compiler-friendly, fully static shapes, safe
under jit/vmap/while_loop.

Update math (identical to the reference):
  insert (online_inverse.h:184-251): Sherman–Morrison block bordering —
    u1 = A_Γᵀv, u2 = B·u1, d = 1/(vᵀv − u1ᵀu2), B += d·u2u2ᵀ,
    new row/col = −d·u2, corner = d, then permute rank k → r.
  remove (online_inverse.h:253-293): permute rank r → k−1, then Schur
    downdate B := B − u uᵀ/d with u the last column, d the corner.

Both paths are written so the k==0 / k==1 special cases of the reference
fall out of the general masked formulas (no lax.cond needed).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..ops import blas
from . import active_set


class InverseState(NamedTuple):
    """Padded inverse + active-set bookkeeping carried through while_loop."""
    inv: jnp.ndarray      # (capacity, capacity), live k×k block in rank order
    indices: jnp.ndarray  # (capacity,) int32 ascending, padded with n
    mask: jnp.ndarray     # (n,) bool membership
    k: jnp.ndarray        # scalar int32, live size


def init(capacity: int, n: int, dtype) -> InverseState:
    return InverseState(
        inv=jnp.zeros((capacity, capacity), dtype=dtype),
        indices=jnp.full((capacity,), n, dtype=jnp.int32),
        mask=jnp.zeros((n,), dtype=bool),
        k=jnp.int32(0),
    )


def _move_perm(capacity: int, src, dest):
    """Permutation vector moving row/col ``src`` to ``dest`` with intermediate
    entries shifted — the reference's ``square_permute``
    (online_inverse.h:76-117) expressed as a gather index vector."""
    i = jnp.arange(capacity, dtype=jnp.int32)
    fwd = jnp.where(i < src, i, jnp.where(i < dest, i + 1, jnp.where(i == dest, src, i)))
    bwd = jnp.where(i < dest, i, jnp.where(i == dest, src, jnp.where(i <= src, i - 1, i)))
    return jnp.where(src <= dest, fwd, bwd)


def square_permute(A: jnp.ndarray, src, dest) -> jnp.ndarray:
    """Apply the src→dest row+column rotation to a square matrix."""
    perm = _move_perm(A.shape[0], src, dest)
    return A[perm][:, perm]


def insert(state: InverseState, col: jnp.ndarray, u1_full: jnp.ndarray,
           vtv: jnp.ndarray) -> InverseState:
    """Insert column index ``col`` whose Gram row is supplied.

    ``u1_full`` must be (AᵀA)[:, col] over all n columns (i.e. Aᵀ·A[:,col]);
    the live entries A_Γᵀv are gathered here. ``vtv`` = vᵀv.
    Reference: online_inverse.h:184-251.
    """
    inv, indices, mask, k = state
    capacity = inv.shape[0]
    n = mask.shape[0]
    dtype = inv.dtype

    # sorted-set bookkeeping: rank + shifted index vector (the reference's
    # rank_index::insert, rank_index.h:40-75)
    new_indices, r = active_set.insert(indices, col, n)

    # u1 = A_Γᵀ v in rank order; padding slots (sentinel n) gather 0.
    u1 = jnp.take(u1_full, indices, mode="fill", fill_value=0)
    u2 = blas.xgemv(inv, u1)
    d = jnp.array(1, dtype) / (vtv - blas.xdot(u1, u2))

    # rank-1 update of the existing k×k block (zero-padded ⇒ no-op outside)
    new_inv = blas.xger(d, u2, u2, inv)

    # border: row/col k = −d·u2, corner = d (insert_last_rowcol analog).
    # Row/col k of the padded buffer are zero before this (outside the live
    # block, and u2[k] = 0), so a direct set is exact.
    i = jnp.arange(capacity, dtype=jnp.int32)
    u3 = jnp.where(i < k, -d * u2, jnp.array(0, dtype))
    row_k = u3.at[k].set(d)
    new_inv = new_inv.at[k, :].set(row_k)
    new_inv = new_inv.at[:, k].set(row_k)

    # permute the bordered row/col from rank k to rank r
    new_inv = square_permute(new_inv, k, r)

    return InverseState(
        inv=new_inv,
        indices=new_indices,
        mask=mask.at[col].set(True),
        k=k + 1,
    )


def _swap_rowcol(M: jnp.ndarray, i, j) -> jnp.ndarray:
    """Exchange rows i,j and columns i,j of a square matrix using dynamic
    slices + broadcast selects — no gather. A (k×k) double-gather
    permutation measured about an order of magnitude slower than these
    selects on the previous accelerator, which is why the unordered fast
    path swaps instead of rotating."""
    cap = M.shape[0]
    idx = jnp.arange(cap)
    is_i = (idx == i)[:, None]
    is_j = (idx == j)[:, None]
    ri = lax.dynamic_slice_in_dim(M, i, 1, axis=0)
    rj = lax.dynamic_slice_in_dim(M, j, 1, axis=0)
    M = jnp.where(is_i, rj, jnp.where(is_j, ri, M))
    ci = lax.dynamic_slice_in_dim(M, i, 1, axis=1)
    cj = lax.dynamic_slice_in_dim(M, j, 1, axis=1)
    return jnp.where(is_i.T, cj, jnp.where(is_j.T, ci, M))


def swap_drop_rowcol(M: jnp.ndarray, pos, last) -> jnp.ndarray:
    """Swap rows/cols pos↔last and zero out row/col ``last`` — the
    companion-matrix form of an unordered removal (used for the active
    Gram submatrix kept in lockstep with the inverse)."""
    p = _swap_rowcol(M, pos, last)
    i = jnp.arange(M.shape[0])
    keep = i != last
    return jnp.where(keep[:, None] & keep[None, :], p, 0)


def insert_unordered(state: InverseState, col: jnp.ndarray,
                     u1: jnp.ndarray, vtv: jnp.ndarray) -> InverseState:
    """Insert ``col`` by *appending* its bordered row/col at slot k.

    Same Sherman–Morrison bordering as :func:`insert`
    (reference: online_inverse.h:184-251) but without the reference's
    rank-order ``square_permute`` — the active set is kept in insertion
    order, which every consumer (direction update, candidate scan) is
    invariant to. ``u1`` is already gathered to the live slots:
    u1[i] = (AᵀA)[indices[i], col], zero in padding slots.
    """
    inv, indices, mask, k = state
    capacity = inv.shape[0]
    dtype = inv.dtype

    u2 = blas.xgemv(inv, u1)
    d = jnp.array(1, dtype) / (vtv - blas.xdot(u1, u2))

    new_inv = blas.xger(d, u2, u2, inv)
    i = jnp.arange(capacity, dtype=jnp.int32)
    u3 = jnp.where(i < k, -d * u2, jnp.array(0, dtype))
    row_k = u3.at[k].set(d)
    new_inv = new_inv.at[k, :].set(row_k)
    new_inv = new_inv.at[:, k].set(row_k)

    return InverseState(
        inv=new_inv,
        indices=indices.at[k].set(col.astype(jnp.int32)),
        mask=mask.at[col].set(True),
        k=k + 1,
    )


def remove_unordered(state: InverseState, col: jnp.ndarray) -> InverseState:
    """Remove ``col`` from an insertion-ordered inverse: swap its slot with
    the last live slot (select-based, no gather), then Schur-downdate —
    the same math as :func:`remove` (reference: online_inverse.h:253-293)
    with the rotation replaced by a swap."""
    inv, indices, mask, k = state
    capacity = inv.shape[0]
    n = mask.shape[0]
    dtype = inv.dtype

    pos = jnp.argmax(indices == col).astype(jnp.int32)
    last = k - 1

    p = _swap_rowcol(inv, pos, last)
    d = p[last, last]
    i = jnp.arange(capacity, dtype=jnp.int32)
    u = jnp.where(i < last, p[:, last], jnp.array(0, dtype))
    new_inv = p - jnp.outer(u, u) / d

    keep = i < last
    new_inv = jnp.where(keep[:, None] & keep[None, :], new_inv, 0)

    new_indices = indices.at[pos].set(indices[last]).at[last].set(
        jnp.int32(n))

    return InverseState(
        inv=new_inv,
        indices=new_indices,
        mask=mask.at[col].set(False),
        k=last,
    )


def remove(state: InverseState, col: jnp.ndarray) -> InverseState:
    """Remove column index ``col`` from the inverse.

    Reference: online_inverse.h:253-293 (permute-to-last + Schur downdate).
    """
    inv, indices, mask, k = state
    capacity = inv.shape[0]
    n = mask.shape[0]
    dtype = inv.dtype

    # sorted-set bookkeeping (the reference's rank_index::erase)
    new_indices, r = active_set.remove(indices, col, n)
    last = k - 1

    # bring row/col r to the end of the live block
    p = square_permute(inv, r, last)

    d = p[last, last]
    i = jnp.arange(capacity, dtype=jnp.int32)
    u = jnp.where(i < last, p[:, last], jnp.array(0, dtype))
    new_inv = p - jnp.outer(u, u) / d

    # erase the last live row/col (erase_last_rowcol analog)
    keep = i < last
    new_inv = jnp.where(keep[:, None] & keep[None, :], new_inv, 0)

    # pad the vacated tail slot (the set shrank to `last` members)
    new_indices = jnp.where(i < last, new_indices, jnp.int32(n))

    return InverseState(
        inv=new_inv,
        indices=new_indices,
        mask=mask.at[col].set(False),
        k=last,
    )
