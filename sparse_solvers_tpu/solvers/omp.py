"""Orthogonal Matching Pursuit — fixed-shape greedy sparse recovery.

Beyond-reference capability (the reference ships homotopy + IRLS only):
OMP is the standard greedy companion to those solvers — at each step it
adds the column most correlated with the residual and re-solves the
least-squares problem on the grown support

    Γ ← Γ ∪ {argmaxⱼ |aⱼᵀ r|},   x_Γ = argmin ‖y − A_Γ x‖₂,   r = y − A_Γ x_Γ

until ‖r‖₂ ≤ tolerance or the support budget is spent (Pati, Rezaiifar
& Krishnaprasad 1993; Tropp & Gilbert 2007).

Device design — the same fixed-shape machinery as the homotopy
loop (solvers/homotopy.py):

  * one ``lax.while_loop`` whose state carries the k_max-capacity
    online Gram inverse (linalg/online_inverse.py) — the LS re-solve is
    x_Γ = (A_ΓᵀA_Γ)⁻¹ A_Γᵀy, one (k,k)·(k,) gemv against the
    incrementally-updated inverse instead of a per-iteration QR;
  * A_Γᵀy never touches A: its entries are c0[Γ] for c0 = Aᵀy computed
    once, so the per-iteration cost is the single correlation product
    c = c0 − (AᵀA) x̂ (Gram-gather or two gemvs — the homotopy
    q-phase cost), plus O(k²) slot-space updates;
  * ‖r‖₂ is free: r ⊥ A_Γ x̂ at the LS solution, so
    ‖r‖² = ‖y‖² − (A_Γᵀy)ᵀ x_Γ — no residual materialization;
  * batching is ``vmap`` (per-lane support state), and no ``lax.cond``
    closes over the sensing matrix (see homotopy.py module docstring).

Modes (static), per the framework convention that anything affecting fp
trajectories has an exact-arithmetic counterpart:
  * ``mode="fast"`` (default) — insertion-ordered active set, Gram
    gathers when a precomputed G exists, correlations from the identity
    c = c0 − (AᵀA)x̂ (algebraically the definition of Aᵀr — not a
    drifting recurrence: recomputed from x̂ every iteration).
  * ``mode="exact"`` — rank-ordered active set and the literal
    r = y − A x̂, c = Aᵀ r dense products.
Both visit the identical support sequence in exact arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..linalg import online_inverse as oinv
from ..ops import blas
from ..ops.operators import DenseOperator


class OmpReportArrays(NamedTuple):
    """Traced report fields (pytree): iterations = support size reached,
    solution_error = final residual ℓ₂ norm ‖y − Ax‖₂."""
    iter: jnp.ndarray            # uint32
    solution_error: jnp.ndarray  # ‖r‖₂


class _LoopState(NamedTuple):
    it: jnp.ndarray
    c: jnp.ndarray       # (n,) current residual correlations Aᵀr
    inv: oinv.InverseState
    coef: jnp.ndarray    # (k_max,) LS coefficients in slot order
    rss: jnp.ndarray     # ‖r‖² (scalar)
    broke: jnp.ndarray   # degenerate insert — stop, solution intact
    done: jnp.ndarray    # rss stalled — stop, iterate kept


def solve_omp(A: jnp.ndarray, y: jnp.ndarray, tolerance,
              max_iterations: int, k_max: int | None = None, *,
              mode: str = "fast", picks: int = 1):
    """OMP on a dense on-device A; returns (x, OmpReportArrays).
    jit/vmap-safe; ``max_iterations``, ``k_max``, ``mode`` and
    ``picks`` static (``picks`` > 1 = generalized OMP, see
    solve_omp_core)."""
    return solve_omp_core(DenseOperator(A), A.shape[1], y, tolerance,
                          max_iterations, k_max, mode=mode, picks=picks)


def solve_omp_core(op, n: int, y: jnp.ndarray, tolerance,
                   max_iterations: int, k_max: int | None = None, *,
                   mode: str = "fast", corr: str | None = None,
                   picks: int = 1):
    """OMP loop over an abstract sensing operator (ops/operators.py —
    dense on one device, or a row-shard whose rmatvec psums inside
    shard_map).

    ``k_max`` caps the support (static buffer capacity); OMP only ever
    inserts, so the default min(max_iterations, m, n) can never
    overflow. ``tolerance`` is the absolute residual target ‖r‖₂.

    ``corr`` (static) selects the fast-mode correlation-update
    formulation — independent of the per-pick insert, which always uses
    op.G when present:
      * "gram"   — Gram-column gathers, O(n·k) bytes/iteration, zero
        passes over A (needs op.has_gram);
      * "sparse" — gather the k active columns of A, then one rmatvec:
        O(k·m) gathered bytes per lane. Right for single/low-batch
        solves; under a large vmap the gather materializes a
        (batch·k, m) tensor that dwarfs one dense pass;
      * "dense"  — scatter x̂ dense and run the two full gemms
        A x̂ / Aᵀr; amortized across a large batch this is the
        fastest formulation (the homotopy driver's q-product insight).
    Default None = "gram" when the operator holds a Gram else "sparse"
    (api.Omp routes by batch — see Omp._route_corr).

    ``picks`` (static, ≥ 1): generalized OMP (gOMP, Wang–Kwon–Shim
    2012) — each round selects the ``picks`` largest inactive
    correlations, inserts them all, and runs ONE LS re-solve and ONE
    correlation update. The expensive per-round work (the correlation
    product — a full pass over A in the dense form) is amortized across
    ``picks`` support additions, so a k-sparse recovery costs ~k/picks
    correlation passes instead of k. Selection order within a round is
    descending |c| with leftmost tie-break (lax.top_k). Degenerate
    sub-inserts are skipped individually; a round that commits nothing
    breaks with the previous iterate intact. ``max_iterations`` remains
    the COLUMN budget (iter = support size reached, as for picks=1) and
    the residual stop/stall tests run per round. gOMP may overshoot the
    minimal support by up to picks−1 columns near the tolerance — the
    standard trade for the pass amortization.
    """
    if picks < 1:
        raise ValueError(f"picks must be >= 1, got {picks}")
    if mode not in ("fast", "exact"):
        raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
    fast = mode == "fast"
    if corr is None:
        corr = "gram" if op.has_gram else "sparse"
    if corr not in ("gram", "sparse", "dense"):
        raise ValueError(
            f"corr must be 'gram', 'sparse' or 'dense', got {corr!r}")
    if corr == "gram" and not op.has_gram:
        corr = "sparse"
    corr_gram = fast and corr == "gram"
    dtype = op.dtype
    m = op.shape[0]
    if k_max is None:
        k_max = max(1, min(max_iterations, m, n))
    tol = jnp.asarray(tolerance, dtype)

    # one-time products: every A_Γᵀy the LS solves need is a gather of c0
    c0 = op.rmatvec(y)
    yty = op.mdot(y, y)

    init = _LoopState(
        it=jnp.uint32(0),
        c=c0,
        inv=oinv.init(k_max, n, dtype),
        coef=jnp.zeros((k_max,), dtype),
        rss=yty,
        broke=jnp.bool_(False),
        done=jnp.bool_(False),
    )

    def _try_insert(inv, idx, eligible):
        """One guarded bordered insert (shared by the single-pick path
        and the gOMP round): returns (inv', committed)."""
        u1, vtv = (op.gram_gathered(idx, inv.indices) if fast
                   else op.gram_column(idx))
        if fast:
            uslot = u1
        else:
            uslot = jnp.take(u1, inv.indices, mode="fill", fill_value=0)
        # degenerate-insert guard (both modes — OMP has no reference
        # twin to stay op-faithful to): a rank-deficient pick makes the
        # Schur complement den = vᵀv − u1ᵀBu1 rounding noise and the
        # downdated inverse infinite.
        den = vtv - blas.xdot(uslot, blas.xgemv(inv.inv, uslot))
        tiny = jnp.asarray(256 * jnp.finfo(dtype).tiny, dtype)
        ok = eligible & (jnp.abs(den) > tiny)
        u1_safe = jnp.where(ok, u1, jnp.zeros_like(u1))
        vtv_safe = jnp.where(ok, vtv, jnp.array(1, dtype))
        ins = oinv.insert_unordered if fast else oinv.insert
        inv1 = ins(inv, idx, u1_safe, vtv_safe)
        sel = lambda a, b: jnp.where(ok, a, b)
        return oinv.InverseState(
            inv=sel(inv1.inv, inv.inv),
            indices=sel(inv1.indices, inv.indices),
            mask=sel(inv1.mask, inv.mask),
            k=sel(inv1.k, inv.k)), ok

    def body(s: _LoopState) -> _LoopState:
        scores = jnp.where(s.inv.mask, jnp.array(-1, dtype), jnp.abs(s.c))
        if picks == 1:
            # greedy pick over the inactive set; |c| >= 0 so −1 masks
            # the active columns out. argmax = leftmost tie-break (the
            # framework convention, matching the reference's ixamax
            # semantics).
            idx = jnp.argmax(scores)
            inv1, ok = _try_insert(s.inv, idx, jnp.bool_(True))
            ncommit = ok.astype(jnp.uint32)
            broke = ~ok
        else:
            # gOMP round: top-`picks` inactive scores (descending,
            # leftmost tie-break), inserted sequentially so each
            # sub-insert's Gram column sees the grown support; a pick
            # whose score is the active sentinel (−1: fewer inactive
            # columns than picks) or that overflows k_max is gated off
            vals, idxs = lax.top_k(scores, picks)
            inv1 = s.inv
            ncommit = jnp.uint32(0)
            for j in range(picks):
                # strictly positive correlation, matching the oracle's
                # degenerate-round guard (a zero-correlation column adds
                # nothing; admitting it forked engine/oracle supports —
                # review finding). The picks=1 path keeps the legacy
                # argmax semantics.
                eligible = ((vals[j] > 0)
                            & (s.it + ncommit
                               < jnp.uint32(max_iterations))
                            & (inv1.k < k_max))
                inv1, ok = _try_insert(inv1, idxs[j], eligible)
                ncommit = ncommit + ok.astype(jnp.uint32)
            broke = ncommit == 0
        it = s.it + ncommit

        # LS re-solve on the grown support: b_Γ = c0[Γ] (slot gather),
        # coefficients = (A_ΓᵀA_Γ)⁻¹ b_Γ
        b_act = jnp.take(c0, inv1.indices, mode="fill", fill_value=0)
        coef1 = blas.xgemv(inv1.inv, b_act)

        # residual correlations and ‖r‖², recomputed from the new
        # coefficients (no drifting recurrence). Wherever an A-pass
        # already happens the true residual is materialized and ‖r‖²
        # accumulated directly; only the Gram-gather path (which never
        # forms the m-vector — that is its point) uses the identity
        # ‖r‖² = ‖y‖² − (A_Γᵀy)ᵀx_Γ, whose cancellation noise floor
        # (~eps·‖y‖²) bounds how tight a tolerance it can resolve —
        # overshoot just pads the support with ~0 coefficients.
        if corr_gram:
            c1 = c0 - op.gram_matvec_sparse(None, inv1.indices, vals=coef1)
            rss1 = yty - blas.xdot(b_act, coef1)
        else:
            if fast and corr == "sparse":
                ax = op.matvec_sparse(None, inv1.indices, vals=coef1)
            else:  # "dense", and exact mode's literal products
                xd = jnp.zeros((n,), dtype).at[inv1.indices].set(
                    coef1, mode="drop")
                ax = op.matvec(xd)
            resid = y - ax
            c1 = op.rmatvec(resid)
            rss1 = op.mdot(resid, resid)

        # a broken lane keeps its previous state wholesale (the toggle
        # above ran on the virtual orthogonal column; discard it)
        keep = lambda new, old: jnp.where(broke, old, new)
        inv_out = oinv.InverseState(
            inv=keep(inv1.inv, s.inv.inv),
            indices=keep(inv1.indices, s.inv.indices),
            mask=keep(inv1.mask, s.inv.mask),
            k=keep(inv1.k, s.inv.k),
        )
        # ‖r‖² is strictly decreasing in exact arithmetic (each added
        # column reduces the LS error by (aᵀr)²/‖P⊥a‖² > 0), so a
        # non-decrease means the rounding floor of whichever rss form is
        # in use — stop with the (valid) new iterate instead of padding
        # the support with noise picks.
        done = keep(rss1, s.rss) >= s.rss
        return _LoopState(
            # a degenerate pick is discarded wholesale — including its
            # iteration count (the native twin breaks before counting);
            # `it` already carries only the committed inserts
            it=it,
            c=keep(c1, s.c),
            inv=inv_out,
            coef=keep(coef1, s.coef),
            rss=keep(rss1, s.rss),
            broke=broke,
            done=done,
        )

    def cond(s: _LoopState):
        err2 = jnp.maximum(s.rss, jnp.array(0, dtype))
        return ((~s.broke) & (~s.done)
                & (s.it < jnp.uint32(max_iterations))
                & (s.inv.k < k_max)
                & (err2 > tol * tol))

    final = lax.while_loop(cond, body, init)
    x = jnp.zeros((n,), dtype).at[final.inv.indices].set(final.coef,
                                                         mode="drop")
    if corr_gram:
        # the in-loop identity rss saturates at its cancellation floor
        # (~eps·‖y‖²) long before the true residual does — report the
        # real thing from one final O(m·k_max) column-gather matvec
        resid = y - op.matvec_sparse(None, final.inv.indices,
                                     vals=final.coef)
        err = jnp.sqrt(op.mdot(resid, resid))
    else:
        err = jnp.sqrt(jnp.maximum(final.rss, jnp.array(0, dtype)))
    return x, OmpReportArrays(iter=final.it, solution_error=err)
