"""CG-accelerated IRLS — matrix-free basis pursuit for the m ≤ n regime.

The reference's IRLS requires an overdetermined system and a one-time QR
(``"underdetermined systems not supported"``, reference:
src/solvers/irls_test.cpp:53, QR assert qr_decomposition.h:101). This
module covers the complementary regime with the classical
Daubechies–DeVore–Fornasier–Güntürk IRLS for

    min ‖x‖₁  s.t.  A x = y,      A: (m, n), m ≤ n,

whose inner weighted-least-norm step is solved by conjugate gradients
(Fornasier, Peter, Rauhut, Worm — "Conjugate gradient acceleration of
iteratively re-weighted least squares methods", arXiv:1509.04063). The
iteration is **factorization-free**: per outer step it touches A only
through matvec/rmatvec pairs, so it runs on problems where a QR or Gram
matrix cannot be materialized, and it shards column-wise (n, the large
axis of this regime) with exactly one ``psum`` per CG matvec
(parallel/sharding.irls_cg_sharded).

Algorithm (p-reweighted; p = 1 is the convex ℓ₁ case, p < 1 matches the
reference's non-convex flavor, irls-cpu.cpp:70):

    D_i = (x_i² + ε²)^(1 − p/2)                  (inverse weights)
    solve (A D Aᵀ) z = y by CG (warm-started)     ← all the work
    x ← D ∘ (Aᵀ z)                                (weighted least norm)
    ε ← min(ε, r_{K+1}(x) / n)                    (K+1-th largest |x|)

until the relative sup-norm change of x falls below ``tolerance`` or
``max_iterations`` outer steps. A D Aᵀ is SPD for ε > 0 and m ≤ n, so CG
is the natural inner solver; each CG step costs one matvec + one rmatvec
(2mn FLOPs) — two gemvs.

Report-field parity with the reference IRLS (include/ss/policies.h:58-71):
``iter``/``solution_error``/``spd_failure`` — solution_error is the final
ε (the reference reports its reweighting eps, irls-cpu.cpp:123, not a
residual) and spd_failure flags an inner-CG breakdown (a non-positive or
non-finite curvature pᵀBp — the analog of the reference's Cholesky pivot
failure, irls-cpu.cpp:50-51). Unlike the reference's needle-matching IRLS
there is no final x/Σx normalization: basis-pursuit solutions are signed.

Device notes: both loops are ``lax.while_loop``; state updates are
gated per-lane on a live flag so ``vmap`` lanes that converge early stay
bit-stable while other lanes continue; everything is fixed-shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..ops import blas
from .irls import IrlsReportArrays


class _CgState(NamedTuple):
    it: jnp.ndarray
    z: jnp.ndarray
    r: jnp.ndarray
    p: jnp.ndarray
    rs: jnp.ndarray        # ⟨r, r⟩
    broke: jnp.ndarray     # curvature breakdown


class _OuterState(NamedTuple):
    it: jnp.ndarray
    started: jnp.ndarray
    x: jnp.ndarray
    z: jnp.ndarray         # CG warm start carried across outer steps
    eps: jnp.ndarray
    change: jnp.ndarray    # last relative sup-norm change of x
    broke: jnp.ndarray     # CG breakdown → spd_failure


def _pdot(a, b):
    return jnp.sum(a * b)


def _cg_solve(body_matvec, y, z0, cg_tol2, max_cg, dtype):
    """Conjugate gradients for B z = y, warm-started at z0.

    ``body_matvec(v)`` applies B = A D Aᵀ (SPD). Stops when ⟨r,r⟩ ≤
    cg_tol2, on ``max_cg`` steps, or on curvature breakdown (pᵀBp ≤ 0 or
    non-finite — B numerically lost positive-definiteness). In the
    column-sharded case z/r/p/y are replicated m-vectors and the psum
    lives inside ``body_matvec``, so the dot products here are local
    either way.
    """
    r0 = y - body_matvec(z0)
    init = _CgState(it=jnp.uint32(0), z=z0, r=r0, p=r0,
                    rs=_pdot(r0, r0), broke=jnp.bool_(False))

    def cond(s: _CgState):
        return (~s.broke) & (s.it < jnp.uint32(max_cg)) & (s.rs > cg_tol2)

    def body(s: _CgState) -> _CgState:
        Bp = body_matvec(s.p)
        pBp = _pdot(s.p, Bp)
        okc = jnp.isfinite(pBp) & (pBp > jnp.array(0, dtype))
        alpha = s.rs / jnp.where(okc, pBp, jnp.array(1, dtype))
        z = s.z + alpha * s.p
        r = s.r - alpha * Bp
        rs = _pdot(r, r)
        # a positive-subnormal curvature passes the okc gate but makes
        # alpha overflow; the NaN/inf surfaces in rs — treat it as the
        # same breakdown (otherwise NaN rs would exit the loop through a
        # false comparison with broke unset, and the outer step would
        # commit a NaN iterate as converged)
        ok = okc & jnp.isfinite(rs)
        z = jnp.where(ok, z, s.z)
        r = jnp.where(ok, r, s.r)
        rs = jnp.where(ok, rs, s.rs)
        beta = rs / s.rs
        p = jnp.where(ok, r + beta * s.p, s.p)
        return _CgState(it=s.it + 1, z=z, r=r, p=p, rs=rs, broke=~ok)

    return lax.while_loop(cond, body, init)


def _global_kth_largest(v_abs, k, axis_name):
    """(k+1)-th largest entry of |x| (0-based k), globally across the
    sharded axis when ``axis_name`` is set: local top-(k+1) candidates are
    all-gathered (tiny: ndev·(k+1) values), then reduced again."""
    kk = min(k + 1, v_abs.shape[0])
    top = lax.top_k(v_abs, kk)[0]
    if axis_name:
        top = lax.all_gather(top, axis_name).reshape(-1)
        top = lax.top_k(top, min(k + 1, top.shape[0]))[0]
    return top[-1]


def solve_irls_cg(A: jnp.ndarray, y: jnp.ndarray, tolerance,
                  max_iterations: int, *, p: float = 1.0,
                  k_sparsity: int | None = None,
                  cg_max_iterations: int | None = None,
                  cg_tolerance: float | None = None):
    """Dense single-device CG-IRLS; returns (x, IrlsReportArrays)."""
    m, n = A.shape
    mv = lambda v: blas.xgemv(A, v)
    rmv = lambda u: blas.xgemv(A, u, trans=True)
    return solve_irls_cg_core(
        mv, rmv, m, n, y, tolerance, max_iterations, p=p,
        k_sparsity=k_sparsity, cg_max_iterations=cg_max_iterations,
        cg_tolerance=cg_tolerance, dtype=A.dtype)


def solve_irls_cg_core(matvec, rmatvec, m: int, n: int, y, tolerance,
                       max_iterations: int, *, p: float = 1.0,
                       k_sparsity: int | None = None,
                       cg_max_iterations: int | None = None,
                       cg_tolerance: float | None = None,
                       dtype=jnp.float32, n_local: int | None = None,
                       n_axis: str | None = None):
    """CG-IRLS over abstract A products.

    ``matvec(x)``: (n_local,) → (m,);  ``rmatvec(u)``: (m,) → (n_local,).
    For column sharding pass ``n_axis`` (the mesh axis partitioning n;
    matvec must psum over it internally — ops/operators.py
    ColShardedOperator) and ``n_local``; the m-sized CG iterates are then
    replicated, so the CG dot products stay local. ``k_sparsity`` is the
    K of the ε-rule ε ← min(ε, r_{K+1}(x)/n) — any K at or above the true
    sparsity preserves recovery (arXiv:1509.04063 §2.2); default m // 4.

    Per-lane state updates are gated on a live flag, so under ``vmap``
    early-converged lanes are bit-stable while others run.
    """
    if not (0 < p <= 1.0):
        raise ValueError(f"p must be in (0, 1], got {p}")
    if k_sparsity is not None and k_sparsity < 1:
        raise ValueError(f"k_sparsity must be >= 1, got {k_sparsity}")
    if cg_max_iterations is not None and cg_max_iterations < 1:
        # a zero-step CG would return z = z0 and the first outer step
        # would "converge" to x = 0 silently
        raise ValueError(
            f"cg_max_iterations must be >= 1, got {cg_max_iterations}")
    if cg_tolerance is not None and not cg_tolerance > 0:
        raise ValueError(f"cg_tolerance must be > 0, got {cg_tolerance}")
    n_local = n_local if n_local is not None else n
    K = k_sparsity if k_sparsity is not None else max(1, m // 4)
    max_cg = cg_max_iterations if cg_max_iterations is not None else min(m, 128)
    tol = jnp.asarray(tolerance, dtype)
    finfo = np.finfo(np.dtype(dtype))
    if cg_tolerance is None:
        # the outer change floor is set by the inner solve's accuracy: a
        # CG solved to relative residual η leaves x jittering at ~η per
        # outer step, so η must sit below tolerance (tol/10) — while
        # never demanding more than the dtype can deliver (10·eps) nor
        # working harder than √eps when the outer tolerance is loose.
        # Computed in-graph: tolerance may be a traced jit argument.
        cg_rel = jnp.maximum(
            jnp.asarray(10 * finfo.eps, dtype),
            jnp.minimum(jnp.asarray(float(np.sqrt(finfo.eps)), dtype),
                        tol / 10))
    else:
        cg_rel = jnp.asarray(cg_tolerance, dtype)
    # absolute CG target: ‖r‖ ≤ cg_rel · ‖y‖
    ynorm2 = _pdot(y, y)
    cg_tol2 = cg_rel ** 2 * ynorm2
    pexp = jnp.array(1.0 - p / 2.0, dtype)

    def weights(x, eps):
        return jnp.power(x * x + eps * eps, pexp)   # D = W⁻¹

    def step(x, z_warm, eps):
        D = weights(x, eps)
        B = lambda v: matvec(D * rmatvec(v))
        cg = _cg_solve(B, y, z_warm, cg_tol2, max_cg, dtype)
        xn = D * rmatvec(cg.z)
        return xn, cg.z, cg.broke

    init = _OuterState(
        it=jnp.uint32(0), started=jnp.bool_(False),
        x=jnp.zeros((n_local,), dtype), z=jnp.zeros((m,), dtype),
        eps=jnp.array(1, dtype), change=jnp.array(jnp.inf, dtype),
        broke=jnp.bool_(False))

    def cond(s: _OuterState):
        # do-while, like the reference loop (irls-cpu.cpp:92-118)
        return (~s.started) | (
            (~s.broke) & (s.it < jnp.uint32(max_iterations))
            & (s.change > tol))

    def body(s: _OuterState) -> _OuterState:
        # under vmap the loop runs while any lane is live; a finished
        # lane re-enters body, so every update is selected on `live`
        live = cond(s)
        xn, zn, broke = step(s.x, s.z, s.eps)
        xabs = jnp.abs(xn)
        xmax = jnp.max(xabs)
        if n_axis:
            xmax = lax.pmax(xmax, n_axis)
        dmax = jnp.max(jnp.abs(xn - s.x))
        if n_axis:
            dmax = lax.pmax(dmax, n_axis)
        change = dmax / jnp.maximum(xmax, jnp.finfo(dtype).tiny)
        rk1 = _global_kth_largest(xabs, K, n_axis)
        eps = jnp.minimum(s.eps, rk1 / jnp.array(n, dtype))
        ok = live & ~broke
        return _OuterState(
            it=jnp.where(ok, s.it + 1, s.it),
            started=jnp.bool_(True),
            x=jnp.where(ok, xn, s.x),
            z=jnp.where(ok, zn, s.z),
            eps=jnp.where(ok, eps, s.eps),
            change=jnp.where(ok, change, s.change),
            broke=s.broke | (live & broke))

    final = lax.while_loop(cond, body, init)
    report = IrlsReportArrays(iter=final.it, solution_error=final.eps,
                              spd_failure=final.broke)
    return final.x, report
