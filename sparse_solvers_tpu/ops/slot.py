"""Slot-space batch primitives — the per-iteration arithmetic of the
slot-space drivers (solvers/homotopy_batch.py, solvers/omp_batch.py) as
whole-array ``jnp`` that XLA fuses.

    normal_matvec_bf16   q = bf16(D·Aᵀ)·A on an explicit bf16 copy of A
    find_max_gamma       the homotopy γ step-size scan over (b, n)
    transition           homotopy insert/remove on the (b, K, K) slot state
                         plus the direction update
    omp_insert           OMP insert plus least-squares re-solve

Each is elementwise work, minor-axis reductions and two gemms; the
driver's ``while_loop`` carries the state, which XLA updates in place.
Lanes never exchange data, so every function is a per-lane map over the
leading batch axis. Each runs under a ``jax.named_scope`` (slot_*), so a
profiler trace or the compiled HLO names its operations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# 256·finfo(f32).tiny: the degenerate-insert threshold shared by every
# engine (solvers/homotopy.py, solvers/omp.py, csrc OnlineInverse::insert)
# so all of them break on the same inserts
_TINY = 256 * 1.1754944e-38


def gemm_bf16(P: jnp.ndarray, B16: jnp.ndarray, *,
              trans_b: bool = False) -> jnp.ndarray:
    """P·B16 (or P·B16ᵀ): P rounded to bf16, float32 accumulation."""
    return lax.dot_general(P.astype(jnp.bfloat16), B16,
                           (((1,), (1 if trans_b else 0,)), ((), ())),
                           preferred_element_type=jnp.float32)


def normal_matvec_bf16(A16: jnp.ndarray, D: jnp.ndarray) -> jnp.ndarray:
    """Q = bf16(D·Aᵀ)·A — the one-pass q product.

    A16: (m, n) bfloat16; D: (b, n) float32, rounded to bf16 on entry →
    Q: (b, n) float32. Two gemms with bf16 operands and float32
    accumulation; the (b, m) intermediate is rounded to bf16 before the
    second product (reference product: src/solvers/homotopy-cpu.cpp:
    111-120). Against the float32 two-gemm form it reads A in half the
    bytes and runs on the bf16 tensor-core rate.
    """
    return gemm_bf16(gemm_bf16(D, A16, trans_b=True), A16)


def _min_leftmost(vals, pos, big):
    """Row minimum of ``vals`` and the smallest ``pos`` among the minima,
    in one variadic reduction over the last axis."""
    def pick(a, b):
        av, ap = a
        bv, bp = b
        take_b = (bv < av) | ((bv == av) & (bp < ap))
        return jnp.where(take_b, bv, av), jnp.where(take_b, bp, ap)

    init = (jnp.array(big, vals.dtype), jnp.array(jnp.iinfo(jnp.int32).max,
                                                   jnp.int32))
    return lax.reduce((vals, pos), init, pick, (vals.ndim - 1,))


@jax.named_scope("slot_gamma_scan")
def find_max_gamma(q, c, mask, c_inf, x_act, d_act, indices):
    """Batched homotopy step-size scan (reference ``find_max_gamma``,
    src/solvers/homotopy-cpu.cpp:100-164).

    q/c: (b, n); mask: (b, n) int8, 1 = active; c_inf: (b,);
    x_act/d_act: (b, K); indices: (b, K) int32 (sentinel ≥ n for empty
    slots). Returns (gamma (b,), idx (b,) int32).

      inactive i:    min of (c_inf−c_i)/(1−q_i), (c_inf+c_i)/(1+q_i),
                     each valid iff denom≠0 and 0 < t < FLT_MAX
      active slot s: −x_act[s]/d_act[s], valid iff 0 < t < FLT_MAX, at
                     position indices[s]

    Ties go to the leftmost position, the reference's "running min last
    strictly decreased" rule and ``jnp.argmin``'s first-occurrence rule
    on the merged candidate vector (solvers/homotopy.py
    ``_find_max_gamma``). A lane with no valid candidate returns
    gamma = FLT_MAX, idx = 0: the reference's running-min
    initialization (homotopy-cpu.cpp:123).
    """
    big = float(jnp.finfo(q.dtype).max)
    ci = c_inf[:, None]
    dl = 1.0 - q
    dr = 1.0 + q
    tl = (ci - c) / dl
    tr = (ci + c) / dr
    cl = jnp.where((dl != 0) & (tl > 0) & (tl < big), tl, big)
    cr = jnp.where((dr != 0) & (tr > 0) & (tr < big), tr, big)
    cand = jnp.where(mask > 0, big, jnp.minimum(cl, cr))
    pos = lax.broadcasted_iota(jnp.int32, cand.shape, 1)
    m_in, p_in = _min_leftmost(cand, pos, big)

    ta = -x_act / d_act                       # empty slots: 0/0 → NaN
    ca = jnp.where((ta > 0) & (ta < big), ta, big)
    m_act, p_act = _min_leftmost(ca, indices, big)

    better = (m_act < m_in) | ((m_act == m_in) & (p_act < p_in))
    gamma = jnp.where(better, m_act, m_in)
    idx = jnp.where(better, p_act, p_in)
    return gamma, jnp.where(gamma == big, 0, idx).astype(jnp.int32)


def _mv(M, v):
    """Per-lane matvec (b,K,K)@(b,K) → (b,K); M is symmetric."""
    return jnp.sum(M * v[:, None, :], axis=2)


def _dot1(a, b):
    return jnp.sum(a * b, axis=1, keepdims=True)


def _bordered_insert(inv, u1, vtv, ek, doins):
    """Sherman–Morrison bordering at the one-hot slot ``ek``
    (online_inverse.h:184-251) as one rank-1 add.

    The drivers keep vacant slots with zero rows/cols in the inverse and
    the Gram, u1 = 0 there and the sentinel index, so the bordered update
    collapses exactly to inv′ = inv + d·(u2 − e_k)⊗(u2 − e_k) with
    u2 = inv·u1 and d = 1/(vᵀv − u1ᵀu2): diagonal d, border −d·u2,
    interior +d·u2u2ᵀ. The per-lane ingredients are select-gated, so
    lanes that do not insert add exact zeros and a degenerate lane's
    1/den never reaches live state.

    ``den`` is the Schur complement of the bordered Gram, the squared
    distance of the new column from span(A_Γ). At rank deficiency it is
    rounding noise and 1/den overflows; such an insert is refused and
    flagged (``deg``). Tiny and even negative dens pass, as the
    reference's arithmetic lets them (online_inverse.h:219): coherent
    dictionaries produce noise-level dens whose inverse still converges.

    Returns (inv′, ins (b,1) bool, deg (b,) bool).
    """
    u2 = _mv(inv, u1)
    den = vtv[:, None] - _dot1(u1, u2)
    ok = jnp.abs(den) > _TINY
    deg = doins & ~ok[:, 0]
    ins = (doins & ok[:, 0])[:, None]
    di = 1.0 / jnp.where(ok, den, 1.0)
    sv = jnp.where(ins, u2 - ek, 0.0)
    giv = jnp.where(ins, di, 0.0)
    return inv + (giv * sv)[:, :, None] * sv[:, None, :], ins, deg


@jax.named_scope("slot_transition")
def transition(inv, gk, x_act, d_act, c_act, indices, u1, idx, kk, gamma,
               vtv, cnew, live, doins, dorm, tol, sentinel: int):
    """One batched homotopy state transition.

    inv/gk: (b,K,K); x_act/d_act/c_act/u1: (b,K); indices: (b,K) int32;
    idx/kk: (b,) int32; gamma/vtv/cnew: (b,); live/doins/dorm: (b,) bool;
    tol: scalar; sentinel: the empty-slot index (n). Returns (inv′, gk′,
    x_act′, d_act′, c_act′, indices′, degenerate); ``degenerate`` (b,)
    bool marks lanes whose insert had a
    noise-level Schur complement: their state is left untouched and the
    caller breaks them.

        c_act ← c_act − γ·(gk·d_act)   slot-space correlation recurrence:
            gk = (AᵀA)[Γ,Γ] is kept in lockstep, so the active
            correlations, and the deadzone signs the reference recomputes
            from c every iteration, evolve exactly as c[Γ] does
        x_act ← x_act + γ·d_act        live lanes
        insert (bordering at slot kk) or remove (Schur downdate at the
            removed slot p, last live slot moved into p) on inv and gk
            (linalg/online_inverse; reference online_inverse.h:184-293)
        d_act ← inv′·sign_deadzone(c_act′, tol)
            (reference homotopy-cpu.cpp:257-266, deadzone :59-67)

    Signs come from the correlation values each iteration: this variant's
    γ-candidate list does not bound γ by λ, so on noisy paths an active
    correlation can cross zero between support changes, and carrying
    insert-time signs diverges there.
    """
    K = x_act.shape[1]
    dt = x_act.dtype
    slots = jnp.arange(K, dtype=jnp.int32)[None, :]
    ep_b = (indices == idx[:, None]) & dorm[:, None]
    el_b = slots == (kk - 1)[:, None]
    ek_b = slots == kk[:, None]
    ek = ek_b.astype(dt)
    gamma = gamma[:, None]
    x, d, ca = x_act, d_act, c_act

    inv_i, ins, deg = _bordered_insert(inv, u1, vtv, ek, doins)
    lv = (live & ~deg)[:, None]

    # slot-space steps with the pre-toggle labels (homotopy-cpu.cpp:252,
    # :255 restricted to Γ); frozen lanes keep their values
    x1 = jnp.where(lv, x + gamma * d, x)
    ca1 = jnp.where(lv, ca - gamma * _mv(gk, d), ca)

    # insert: gk′ = gk + u1⊗e_k + e_k⊗(u1 + vtv·e_k); slot k's ca1 is 0
    # on insert lanes (zero gk row, zero ca), so appending c′ is an add
    u1g = jnp.where(ins, u1, 0.0)
    vtvg = jnp.where(ins, vtv[:, None], 0.0)
    gk_i = (gk + u1g[:, :, None] * ek[:, None, :]
            + ek[:, :, None] * (u1g + vtvg * ek)[:, None, :])
    ca_i = ca1 + jnp.where(ins, cnew[:, None], 0.0) * ek
    ind_i = jnp.where(ins & ek_b, idx[:, None], indices)

    # remove: Schur downdate at p, then move the last live slot into p
    # (online_inverse.h:253-293, swap formulation). Computed for every
    # lane and selected per lane: the inert lanes' 0/0 never reaches
    # live state.
    ep = ep_b.astype(dt)
    el = el_b.astype(dt)
    bvec = (1.0 - ep) * (1.0 - el)
    same = _dot1(ep, el)                     # 1 iff p == kk-1
    # p == l (removing the last live slot): the slot is simply dropped
    epm = ep * (1.0 - same)

    def move_last_to_p(M):
        """Zero rows/cols p and l, then place M's row/col l at p
        (diagonal (p,p) ← M[l,l]); no move when p == l."""
        rl = _mv(M, el)
        dll = _dot1(el, rl)
        rl2 = rl * bvec + epm * dll
        return (M * bvec[:, :, None] * bvec[:, None, :]
                + epm[:, :, None] * rl2[:, None, :]
                + epm[:, None, :] * rl2[:, :, None]
                - (epm * dll)[:, :, None] * epm[:, None, :])

    rp = _mv(inv, ep)                        # column p (= row p)
    dpp = _dot1(ep, rp)
    inv_r = move_last_to_p(inv - (rp / dpp)[:, :, None] * rp[:, None, :])
    gk_r = move_last_to_p(gk)

    def vswap(v, fill):
        """Slot l's value into p, ``fill`` into l (p == l: fill)."""
        vl = jnp.sum(jnp.where(el_b, v, 0), axis=1, keepdims=True,
                     dtype=v.dtype)
        return jnp.where(el_b, fill, jnp.where(ep_b & (same < 0.5), vl, v))

    rm = dorm[:, None]
    rm3 = dorm[:, None, None]
    inv2 = jnp.where(rm3, inv_r, inv_i)
    gk2 = jnp.where(rm3, gk_r, gk_i)
    x2 = jnp.where(rm, vswap(x1, 0.0), x1)
    ca2 = jnp.where(rm, vswap(ca1, 0.0), ca_i)
    ind2 = jnp.where(rm, vswap(indices, sentinel), ind_i)

    # direction from the post-toggle state (homotopy-cpu.cpp:257-266)
    sgn = jnp.where(ca2 > tol, 1.0, jnp.where(ca2 < -tol, -1.0, 0.0))
    d2 = jnp.where(lv, _mv(inv2, sgn.astype(dt)), d)
    return inv2, gk2, x2, d2, ca2, ind2, deg


@jax.named_scope("slot_omp_insert")
def omp_insert(inv, u1, kk, vtv, b_act, doins):
    """One batched OMP insert plus least-squares re-solve.

    inv: (b,K,K); u1: (b,K) = (AᵀA)[Γ, idx] over the live slots (zero on
    empty slots); kk: (b,) int32 insert slot; vtv: (b,); b_act: (b,K) =
    A_Γᵀy with the new entry already at slot kk; doins: (b,) bool.
    Returns (inv′, coef, degenerate): the bordered inverse
    (linalg/online_inverse.py insert_unordered; OMP never removes) and
    coef = inv′·b_act, the LS solution x_Γ = (A_ΓᵀA_Γ)⁻¹A_Γᵀy
    (algorithms.md §4). ``degenerate`` lanes keep their inverse; the
    caller breaks them with the previous solution intact.
    """
    K = u1.shape[1]
    ek = (jnp.arange(K, dtype=jnp.int32)[None, :]
          == kk[:, None]).astype(u1.dtype)
    inv1, _, deg = _bordered_insert(inv, u1, vtv, ek, doins)
    return inv1, _mv(inv1, b_act), deg
