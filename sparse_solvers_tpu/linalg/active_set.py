"""Fixed-capacity sorted active set — the fixed-shape analog of ``rank_index``.

The reference maintains the homotopy active set Γ in a sorted ``std::vector``
order-statistic structure (reference: src/linalg/rank_index.h:26-98) whose
size changes every iteration. Inside ``jit``/``lax.while_loop`` all shapes
must be static, so here the set lives in a fixed-capacity int32 vector:

  * the first ``k`` slots hold the member column indices in ascending order;
  * the remaining slots hold the sentinel value ``n`` (one past any valid
    column index), which keeps the whole vector ascending and makes ranks
    computable with a single vectorized comparison.

All operations are pure functions usable under jit/vmap.
"""

from __future__ import annotations

import jax.numpy as jnp


def empty(capacity: int, n: int) -> jnp.ndarray:
    """An empty active set over columns [0, n) with the given capacity."""
    return jnp.full((capacity,), n, dtype=jnp.int32)


def rank_of(indices: jnp.ndarray, value) -> jnp.ndarray:
    """Rank (position) value would occupy / occupies. O(capacity) compare.

    Equals the reference's ``rank_index::rank_of`` for members and its
    ``insert`` return value for non-members (rank_index.h:40-75): padding
    slots hold the sentinel (> any valid value) so they never count.
    """
    return jnp.sum(indices < value).astype(jnp.int32)


def contains(indices: jnp.ndarray, value) -> jnp.ndarray:
    """Membership test (rank_index.h rank_of >= 0 analog)."""
    return jnp.any(indices == value)


def insert(indices: jnp.ndarray, value, n: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Insert value, returning (new_indices, rank). Caller guarantees
    non-membership and spare capacity. Reference: rank_index.h insert."""
    r = rank_of(indices, value)
    i = jnp.arange(indices.shape[0], dtype=jnp.int32)
    shifted = jnp.where(i == 0, value, indices[jnp.maximum(i - 1, 0)])
    out = jnp.where(i < r, indices, jnp.where(i == r, value, shifted))
    return out.astype(jnp.int32), r


def remove(indices: jnp.ndarray, value, n: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Remove value, returning (new_indices, old_rank). Caller guarantees
    membership. Reference: rank_index.h erase."""
    r = rank_of(indices, value)
    i = jnp.arange(indices.shape[0], dtype=jnp.int32)
    cap = indices.shape[0]
    shifted = indices[jnp.minimum(i + 1, cap - 1)]
    out = jnp.where(i < r, indices, shifted)
    # the last slot always becomes padding after a removal
    out = out.at[cap - 1].set(jnp.int32(n))
    return out.astype(jnp.int32), r


def rank_at(indices: jnp.ndarray, rank) -> jnp.ndarray:
    """Value stored at the given rank. Reference: rank_index.h rank_at."""
    return indices[rank]
