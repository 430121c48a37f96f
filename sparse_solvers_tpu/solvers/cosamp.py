"""CoSaMP — Compressive Sampling Matching Pursuit (Needell–Tropp 2009).

Beyond-reference solver family (the reference ships homotopy + IRLS
only; this completes the greedy wing next to OMP/gOMP): per round,

    c   = Aᵀr                                   (proxy correlations)
    Ω   = supp(x) ∪ top_{2k} inactive |c|       (≤ 3k candidate columns)
    b|Ω = argmin ‖y − A_Ω b‖₂                   (one LS on ≤ 3k columns)
    x   = b pruned to its k largest entries     (support REPLACEMENT)
    r   = y − A x

until ‖r‖₂ ≤ tolerance, the round budget is spent, or the residual
stalls. Unlike OMP's insert-only support, CoSaMP replaces the whole
support every round — wrong early picks get evicted, which is what buys
its RIP recovery guarantee.

Fixed-shape design (contrast solvers/omp.py): the support is bounded by
the STATIC target sparsity k, so instead of an online inverse the round
gathers its ≤ 3k candidate columns into a dense (m, 3k) block and
solves the LS by one Cholesky of the 3k×3k candidate Gram — dense
gemms and a small factorization per round, no per-insert bookkeeping.
Fixed shapes throughout: the support is a (k,) index vector (sentinel
n), the union a (k + 2k,) vector; sentinel slots gather zero columns
whose Gram diagonal is patched to 1 — exact: their LS coefficients
solve to 0 and nothing else is perturbed. The 2k selection takes the 2k
largest INACTIVE correlations (the fixed-shape union variant: the union
is always k + 2k distinct-or-sentinel indices), mirrored exactly by the
NumPy oracle (oracle/cosamp.py).

Guards, following the framework conventions: a residual stall
(non-decrease — the rounding floor or a RIP violation) stops the solve
with the PREVIOUS iterate kept (CoSaMP is not monotone off-RIP; OMP's
insert-only loop keeps the new iterate instead, solvers/omp.py:208); a
non-finite round (rank-deficient union Cholesky) likewise. Reports
carry (iter = rounds run, solution_error = final true ‖y − Ax‖₂).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..ops import blas
from .omp import OmpReportArrays


class _CState(NamedTuple):
    it: jnp.ndarray      # uint32 committed rounds
    supp: jnp.ndarray    # (k,) int32 support indices, sentinel n
    vals: jnp.ndarray    # (k,) support values
    rss: jnp.ndarray     # ‖y − Ax‖² of the committed iterate
    done: jnp.ndarray    # bool — stall / non-finite stop


def solve_cosamp(A: jnp.ndarray, y: jnp.ndarray, k_sparsity: int,
                 tolerance, max_iterations: int = 20,
                 axis: str | None = None, m_global: int | None = None):
    """CoSaMP on a dense on-device A; returns (x, OmpReportArrays).
    jit/vmap-safe; ``k_sparsity`` (the target support size — CoSaMP
    requires it, unlike OMP) and ``max_iterations`` (rounds) static.

    ``axis`` runs the round row-sharded inside shard_map: A/y are the
    local row shards and every row reduction — c = Aᵀr, the union Gram
    BᵀB, the rhs Bᵀy, ‖r‖² — ends in one ``lax.psum`` over ``axis``
    (the sharded OMP core's contract); selection, the replicated S×S
    Cholesky and the prune are identical deterministic functions of the
    psum'd values on every shard. ``m_global`` (required with axis)
    sizes the pool clamp by the TRUE row count, not the shard's."""
    m, n = A.shape
    if axis is not None:
        if m_global is None:
            raise ValueError("axis requires m_global (the unsharded "
                             "row count, for the pool clamp)")
        m = m_global
    k = int(k_sparsity)
    if k < 1:
        raise ValueError(f"k_sparsity must be >= 1, got {k_sparsity}")
    if k >= min(m, n):
        raise ValueError(
            f"k_sparsity must be < min(m, n) = {min(m, n)} (the round "
            f"needs a nonempty inactive pool and an overdetermined "
            f"union LS), got {k}")
    dtype = A.dtype
    tol = jnp.asarray(tolerance, dtype)
    # inactive pool: 2k, clamped so the union never exceeds the row
    # count — a union wider than m makes the union Gram singular by
    # construction and the round's Cholesky NaNs into a spurious stall
    # (review finding; classic CoSaMP assumes m ≳ 3k anyway). The m−k
    # clamp keeps the LS overdetermined-or-square; the oracle mirrors
    # it exactly.
    k2 = min(2 * k, n - k, m - k)
    S = k + k2                               # union capacity
    eye_fix = jnp.arange(S)
    psum = ((lambda v: lax.psum(v, axis)) if axis is not None
            else (lambda v: v))

    yty = psum(blas.xdot(y, y))
    init = _CState(
        it=jnp.uint32(0),
        supp=jnp.full((k,), n, jnp.int32),
        vals=jnp.zeros((k,), dtype),
        rss=yty,
        done=jnp.bool_(False),
    )

    def body(s: _CState) -> _CState:
        # committed residual (recomputed — no drifting recurrence):
        # sentinel support slots gather zero columns
        safe_supp = jnp.minimum(s.supp, n - 1)
        cols = jnp.take(A, safe_supp, axis=1) * (s.supp < n).astype(dtype)
        r = y - blas.xgemv(cols, s.vals)
        c = psum(blas.xgemv(A, r, trans=True))

        # 2k largest inactive |c| (leftmost tie-break via top_k);
        # sentinel slots are dropped, not clamped (a clamped duplicate
        # write at n−1 with conflicting values is scatter-order
        # dependent — review finding)
        active = jnp.zeros((n,), bool).at[s.supp].set(True, mode="drop")
        scores = jnp.where(active, jnp.array(-1, dtype), jnp.abs(c))
        _, top2k = lax.top_k(scores, k2)
        omega = jnp.concatenate([s.supp, top2k.astype(jnp.int32)])

        valid = omega < n
        B = (jnp.take(A, jnp.minimum(omega, n - 1), axis=1)
             * valid.astype(dtype))                       # (m, S)
        G = psum(blas.xgemm(B, B, trans_a=True))
        # sentinel diagonal → 1: exact (zero rows/cols elsewhere, rhs 0)
        G = G.at[eye_fix, eye_fix].add(jnp.where(valid, 0, 1).astype(dtype))
        rhs = psum(blas.xgemv(B, y, trans=True))
        L, lower = (jnp.linalg.cholesky(G), True)
        b = lax.linalg.triangular_solve(
            L, lax.linalg.triangular_solve(
                L, rhs[:, None], lower=True, left_side=True)[:, 0][:, None],
            lower=True, left_side=True, transpose_a=True)[:, 0]

        # prune to the k largest |b|
        _, pos = lax.top_k(jnp.abs(b), k)
        supp2 = jnp.take(omega, pos)
        vals2 = jnp.take(b, pos)
        Bp = jnp.take(B, pos, axis=1)
        r2 = y - blas.xgemv(Bp, vals2)
        rss2 = psum(blas.xdot(r2, r2))

        ok = jnp.isfinite(rss2) & (rss2 < s.rss)
        keep = lambda new, old: jnp.where(ok, new, old)
        return _CState(
            it=s.it + ok.astype(jnp.uint32),
            supp=jnp.where(ok, supp2, s.supp),
            vals=keep(vals2, s.vals),
            rss=keep(rss2, s.rss),
            done=~ok,   # stall / non-finite: previous iterate stands
        )

    def cond(s: _CState):
        return ((~s.done) & (s.it < jnp.uint32(max_iterations))
                & (s.rss > tol * tol))

    final = lax.while_loop(cond, body, init)
    x = jnp.zeros((n,), dtype).at[final.supp].set(final.vals, mode="drop")
    err = jnp.sqrt(jnp.maximum(final.rss, jnp.array(0, dtype)))
    return x, OmpReportArrays(iter=final.it, solution_error=err)
