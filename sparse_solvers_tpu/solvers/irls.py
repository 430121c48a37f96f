"""IRLS ℓ₁-minimization solver — Chartrand–Yin reweighting on a cached QR.

Solves  min ‖x‖₁  s.t.  A x = y  by iteratively reweighted least squares
with p = 0.9 reweighting, over a QR factorization computed *once* per
sensing matrix and reused across solves (the reference computes the QR in
the solver constructor — src/lib.cpp:51-57 — and this module preserves that
construct-once/solve-many shape with device-resident Q and R).

Algorithmic parity target: reference src/solvers/irls-cpu.cpp:39-124 —
  * inner Newton step (irls_newton, :39-60): Cholesky of Qᵀ(Q∘w), graceful
    ``spd_failure`` instead of an error (:50-51, :95-97),
  * relative threshold abstol = max(x)·tol (:100-103),
  * eps update from the second-largest (raw, post-threshold) value (:107-110),
  * weights w = (x² + eps)^(p/2−1), sum-normalized (:113-114),
  * do-while loop `iter < max_iter && x₂ > abstol` (:118),
  * final x /= sum(x) (:121),
  * report = {iter, solution_error = eps, spd_failure} (:123) — note the
    reported error is eps, not a residual norm.

Device notes: the loop is one ``lax.while_loop``; the Newton step is two
gemms (Qᵀ(Q∘w) dominates at O(MN²)) + XLA's blocked Cholesky and
triangular solves; vmap over signals shares Q/R across lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..linalg.cholesky import cholesky_spd, cholesky_solve
from ..ops import blas


class IrlsReportArrays(NamedTuple):
    """Traced report fields (pytree) — mirrors ss::irls_report
    (reference: include/ss/policies.h:58-71)."""
    iter: jnp.ndarray            # uint32
    solution_error: jnp.ndarray  # final eps (irls-cpu.cpp:123)
    spd_failure: jnp.ndarray     # bool


class _LoopState(NamedTuple):
    it: jnp.ndarray
    started: jnp.ndarray
    x: jnp.ndarray
    w: jnp.ndarray
    eps: jnp.ndarray
    abstol: jnp.ndarray
    x2: jnp.ndarray
    spd: jnp.ndarray
    broke: jnp.ndarray


def _newton(qop, R, y, w, dtype):
    """One weighted least-squares Newton step (irls-cpu.cpp:39-60).

    qw = Q∘w (column scaling), G = Qᵀqw, s = G⁻¹Qᵀy via Cholesky,
    then x = R⁻¹ Qᵀ(Q s). Returns (x, isspd). ``qop`` abstracts Q products
    (dense or row-sharded with psum — ops/operators.py).
    """
    G = qop.gram_weighted(w)
    L, isspd = cholesky_spd(G)
    qtb = qop.rmatvec(y)
    s = cholesky_solve(L, qtb)
    t = qop.matvec(s)
    xn = qop.rmatvec(t)
    xn = blas.xtrsm(R, xn, lower=False)
    return xn, isspd


def _newton_fast(R, rhs, w, dtype, r_inv=None):
    """Closed-form Newton step exploiting Q's orthonormality.

    Because QᵀQ = I, the reference's step collapses algebraically:
    G = Qᵀ(Q∘w) = diag(w), s = G⁻¹Qᵀy = rhs/w, and Qᵀ(Q s) = s, so
    x = R⁻¹(rhs/w) with rhs = Qᵀy computed once per solve — O(n²) per
    iteration instead of the reference's O(mn²) gemm + O(n³) Cholesky
    (irls-cpu.cpp:47-58). In float32 this is also *better* conditioned:
    the dense Cholesky of diag(w) + O(eps) off-diagonal noise amplifies
    that noise by 1/min(w) as the weights spread.

    ``r_inv`` selects the *batched-throughput* application of R⁻¹: a
    matvec against the explicitly-inverted triangle (cached once per
    sensing matrix), which vmap turns into one (b,n)×(n,n) gemm —
    a back-substitution is a length-n dependency chain a matrix unit
    cannot pipeline across lanes. Algebraically identical, fp trajectory
    differs in the last bits (tests pin iteration parity at the
    reference tolerance regime).

    The reference's spd_failure corresponds to a Cholesky pivot
    √w_j ≤ machine-eps, i.e. min(w) ≤ eps² (cholesky_decomposition.h:
    80-83 with linalg/cholesky.py's pivot criterion).
    """
    eps = jnp.finfo(dtype).eps
    isspd = jnp.min(w) > eps * eps
    if r_inv is not None:
        # full-f32 contraction regardless of the instance precision knob:
        # the back-substitution this replaces is always full precision
        # (triangular_solve has no precision level), so a "default"
        # precision instance must not silently degrade its Newton solve
        # to a TF32 product
        with blas.precision_scope("highest"):
            xn = blas.xgemv(r_inv, rhs / w)
    else:
        xn = blas.xtrsm(R, rhs / w, lower=False)
    return xn, isspd


def solve_irls(Q: jnp.ndarray, R: jnp.ndarray, y: jnp.ndarray, tolerance,
               max_iterations: int, *, mode: str = "fast", r_inv=None,
               stabilized: bool = False):
    """Run IRLS given the economy QR of A; returns (x, IrlsReportArrays).

    Pure function of device arrays — jit/vmap-safe (Q, R broadcast across
    vmapped signals). ``max_iterations``, ``mode`` and ``stabilized``
    are static.
    """
    from ..ops.operators import DenseOperator
    return solve_irls_core(DenseOperator(Q), R, y, tolerance, max_iterations,
                           mode=mode, r_inv=r_inv, stabilized=stabilized)


def solve_irls_core(qop, R: jnp.ndarray, y: jnp.ndarray, tolerance,
                    max_iterations: int, *, mode: str = "fast", r_inv=None,
                    stabilized: bool = False):
    """IRLS loop over an abstract Q operator (dense or row-sharded).

    mode="fast" (default) uses the algebraically collapsed Newton step
    (see _newton_fast): one rmatvec per *solve* and an O(n²) triangular
    solve per iteration — and, in the sharded case, zero collectives per
    iteration. mode="exact" reproduces the reference's dense
    gemm+Cholesky step per iteration. ``r_inv`` (fast mode only) applies
    a precomputed R⁻¹ instead of back-substitution — the batched gemm
    formulation (see _newton_fast).

    ``stabilized`` (beyond reference; composes with either mode) divides
    each Newton iterate by its maximum before the threshold/eps/weight
    updates. The reference recurrence is scale-divergent by
    construction: w is sum-normalized while x = R⁻¹(Qᵀy ∘ w⁻¹), so every
    iteration multiplies x's scale by Σ(x²+eps)^(p/2−1) — ×10³–10⁵ at
    n ≥ 512 — while eps stays frozen at its early-iteration floor
    (eps ← min(eps, x₂/n) never rescales). min(w) therefore collapses
    by the same factor^1.1 per iteration and crosses the Cholesky/pivot
    floor after ~4 iterations in f32 (~8 in f64) on Gaussian ensembles
    — the all-bail regime the round-3 benchmarks recorded
    (docs/algorithms.md §2a has the measured traces). Normalizing the
    iterate makes every quantity scale-free: the support decisions are
    unchanged (threshold abstol = max·tol selects by the same ratios),
    the eps rule becomes genuinely relative, and the weight floor is
    bounded below by (x₂/(n·max))^0.55/n — unreachable in f32 before
    convergence — so lanes iterate until the do-while's own criterion
    (the runner-up falling below tol·max) decides. Same per-iteration
    operation count as the reference recurrence plus one O(n) scale
    pass. Reference: irls-cpu.cpp:92-118 (the recurrence being
    stabilized); oracle/irls.py carries the f64 oracle counterpart.
    """
    if mode not in ("fast", "exact"):
        raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
    if r_inv is not None and mode != "fast":
        raise ValueError("r_inv is a fast-mode option")
    fast = mode == "fast"
    n = R.shape[0]
    dtype = qop.dtype
    tol = jnp.asarray(tolerance, dtype)
    p = 0.9  # reweighting exponent (irls-cpu.cpp:70)
    rhs = qop.rmatvec(y) if fast else None  # Qᵀy, loop-invariant

    init = _LoopState(
        it=jnp.uint32(0),
        started=jnp.bool_(False),
        x=jnp.zeros((n,), dtype),
        w=jnp.ones((n,), dtype),
        eps=jnp.array(1, dtype),
        abstol=jnp.array(1, dtype),
        x2=jnp.array(1, dtype),
        spd=jnp.bool_(False),
        broke=jnp.bool_(False),
    )

    def cond(s: _LoopState):
        # do-while (irls-cpu.cpp:92-118)
        return (~s.started) | (
            (~s.broke) & (s.it < jnp.uint32(max_iterations)) & (s.x2 > s.abstol)
        )

    def body(s: _LoopState) -> _LoopState:
        if fast:
            xn, isspd = _newton_fast(R, rhs, s.w, dtype, r_inv=r_inv)
        else:
            xn, isspd = _newton(qop, R, y, s.w, dtype)

        def on_spd_failure(_):
            # break before committing x (irls-cpu.cpp:94-97); iter unchanged
            return s._replace(started=jnp.bool_(True), spd=jnp.bool_(True),
                              broke=jnp.bool_(True))

        def on_ok(_):
            if stabilized:
                # scale-free iterate: divide by the max (guarded against
                # a degenerate all-nonpositive solve, where the reference
                # arithmetic would zero everything anyway)
                mx = jnp.max(xn)
                xs = jnp.where(mx > 0, xn / mx, xn)
            else:
                xs = xn
            abstol = jnp.max(xs) * tol                       # :100
            xt = jnp.where(xs < abstol, jnp.array(0, dtype), xs)  # :103
            x2 = lax.top_k(xt, 2)[0][1]                      # :107 (raw values)
            eps = jnp.minimum(s.eps, x2 / jnp.array(n, dtype))    # :110
            w = jnp.power(xt * xt + eps, jnp.array(p / 2.0 - 1.0, dtype))  # :113
            w = w / jnp.sum(w)                               # :114
            return _LoopState(it=s.it + 1, started=jnp.bool_(True), x=xt,
                              w=w, eps=eps, abstol=abstol, x2=x2,
                              spd=jnp.bool_(False), broke=jnp.bool_(False))

        return lax.cond(isspd, on_ok, on_spd_failure, None)

    final = lax.while_loop(cond, body, init)

    x = final.x / jnp.sum(final.x)  # irls-cpu.cpp:121
    report = IrlsReportArrays(iter=final.it, solution_error=final.eps,
                              spd_failure=final.spd)
    return x, report
