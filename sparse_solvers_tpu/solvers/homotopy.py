"""Homotopy ℓ₁-minimization solver — fixed-shape path-following.

Solves  min ‖x‖₁  s.t.  Ax = y  by following the homotopy path of
  min_x ‖y − Ax‖₂² + λ‖x‖₁  as λ ↓ tolerance,
maintaining the active-set Gram inverse (A_ΓᵀA_Γ)⁻¹ incrementally.

Algorithmic parity target: the reference CPU solver
(reference: src/solvers/homotopy-cpu.cpp:186-275), including its exact
semantic quirks —
  * leftmost-minimum tie-break in the γ-candidate scan (:156-160),
  * sign deadzone at the solve tolerance (:59-67),
  * the *initial* direction uses sign(‖c‖∞) — i.e. +1 — not sign(c_idx)
    (:223-224),
  * do-while iteration semantics and the K==0 early break (:236-272),
  * report = {iter, solution_error = final ‖c‖∞} (:274).

Device design (vs. the reference's dynamically-sized C++ loop):
  * the whole path loop is one ``lax.while_loop`` over fixed-shape state —
    the active set is a fixed-capacity sorted index vector + boolean mask
    (linalg/active_set.py) and the Gram inverse a zero-padded buffer
    (linalg/online_inverse.py);
  * the O(N) serial γ scan (:130-161) becomes a vectorized candidate
    computation + first-occurrence argmin reduction;
  * the per-iteration matvecs run at HIGHEST precision; batching
    over many signals is ``vmap`` (each lane carries its own support state);
  * no ``lax.cond`` branch ever closes over the sensing matrix — under vmap
    a cond becomes a batched select over its *operands*, and capturing A
    would broadcast a per-lane copy of the full matrix (batch·m·n) and turn
    every shared-A gemm into a batched one. All conds here operate on the
    small per-lane state only.

Two execution modes (static):
  * ``mode="exact"`` — the reference's per-iteration recomputation:
    c = Aᵀ(y − Ax) and q = Aᵀ(A d) as full dense products. Bit-faithful to
    the reference's operation order; 4 full passes over A per iteration.
  * ``mode="fast"`` (default) — same path, algebraically identical updates
    that exploit structure the reference ignores:
      - correlation recurrence  c ← c − γ·q  (exact in real arithmetic:
        Aᵀ(y − A(x+γd)) = c − γ·AᵀAd), eliminating both residual gemvs
        (homotopy-cpu.cpp:255);
      - ``sparse_matvec``: d is k-sparse by construction, so A d gathers
        k_max columns instead of streaming all of A;
      - with a precomputed Gram matrix (operators.DenseOperator.G),
        q = AᵀA d and the insert's Gram column become O(n·k) gathers — the
        hot loop never touches A at all.
    Drift bound: the recurrence accumulates one rounding per iteration
    (~iters·eps·‖c‖), far below the reference's own test tolerances for
    ≤ a few hundred iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..linalg import online_inverse as oinv
from ..ops import blas
from ..ops.operators import DenseOperator


class HomotopyReportArrays(NamedTuple):
    """Traced report fields (pytree) — mirrors ss::homotopy_report
    (reference: include/ss/policies.h:25-32)."""
    iter: jnp.ndarray            # uint32
    solution_error: jnp.ndarray  # final ‖c‖∞


class _LoopState(NamedTuple):
    it: jnp.ndarray
    x: jnp.ndarray
    c: jnp.ndarray
    c_inf: jnp.ndarray
    direction: jnp.ndarray
    inv: oinv.InverseState
    gk: jnp.ndarray     # (k_max, k_max) active Gram submatrix (fast mode)
    c_act: jnp.ndarray  # (k_max,) active correlations in slot order (fast)
    d_act: jnp.ndarray  # (k_max,) direction over slots (fast mode)
    broke: jnp.ndarray
    # regularization-path history (record_path only; (1,1)/(1,) dummies
    # otherwise): per-breakpoint slot values, slot indices, and λ = ‖c‖∞
    hist_v: jnp.ndarray
    hist_i: jnp.ndarray
    hist_l: jnp.ndarray


def _sign_deadzone(v: jnp.ndarray, tol) -> jnp.ndarray:
    """sign with a ±tol deadzone (reference: homotopy-cpu.cpp:59-67)."""
    one = jnp.array(1, v.dtype)
    return jnp.where(v > tol, one, jnp.where(v < -tol, -one, 0))


def _find_max_gamma(q, c, x, direction, c_inf, mask, dtype):
    """Vectorized γ-candidate scan with leftmost-min tie-break.

    Reference: homotopy-cpu.cpp:100-164. For active indices the candidate is
    −x_i/d_i; for inactive ones the two path-crossing terms
    (c_inf ∓ c_i)/(1 ∓ q_i). Candidates must be strictly positive; invalid
    candidates take the dtype max (the reference's running-min init,
    :123). argmin's first-occurrence semantics reproduce the reference's
    "index where the running min last strictly decreased" (= leftmost global
    argmin).
    """
    big = jnp.array(jnp.finfo(dtype).max, dtype)

    t_active = -x / direction
    cand_active = jnp.where((t_active > 0) & (t_active < big), t_active, big)

    dl = 1 - q
    dr = 1 + q
    tl = (c_inf - c) / dl
    tr = (c_inf + c) / dr
    cl = jnp.where((dl != 0) & (tl > 0) & (tl < big), tl, big)
    cr = jnp.where((dr != 0) & (tr > 0) & (tr < big), tr, big)
    cand_inactive = jnp.minimum(cl, cr)

    cand = jnp.where(mask, cand_active, cand_inactive)
    idx = jnp.argmin(cand)
    return cand[idx], idx


def _toggle_support(state: oinv.InverseState, col, u1_full, vtv):
    """Insert or remove column ``col`` from the rank-ordered active set.

    Reference: homotopy-cpu.cpp:166-183 (inverse_add_or_remove). The Gram
    column (u1_full, vtv) is computed by the *caller* so neither branch
    closes over the sensing matrix (see module docstring on vmap+cond).
    """
    return lax.cond(
        state.mask[col],
        lambda s, _u, _v: oinv.remove(s, col),
        lambda s, u, v: oinv.insert(s, col, u, v),
        state, u1_full, vtv,
    )


def _toggle_support_unordered(state: oinv.InverseState, gk, c_act, col,
                              u1, vtv):
    """Fast-path toggle over an insertion-ordered active set: append-style
    insert (no permutation) / swap-style remove.

    Alongside the inverse, two slot-space companions are kept in lockstep
    (see solve_homotopy_core — they make the direction update gather-free):
      * ``gk``   — the active Gram submatrix (AᵀA)[Γ, Γ] in slot order;
        the insert's bordering row/col is exactly the already-gathered
        ``u1`` (+ ``vtv`` on the diagonal), so it costs nothing extra;
      * ``c_act`` — the active correlations c[Γ]; removals swap-drop it,
        the inserted slot's value is written by the caller once the
        updated correlations exist.
    """
    def rm(st, g, ca, _u, _v):
        pos = jnp.argmax(st.indices == col)
        last = st.k - 1
        g = oinv.swap_drop_rowcol(g, pos, last)
        ca = ca.at[pos].set(ca[last]).at[last].set(0)
        return oinv.remove_unordered(st, col), g, ca

    def ins(st, g, ca, u, v):
        k = st.k
        row_k = u.at[k].set(v)
        g = g.at[k, :].set(row_k).at[:, k].set(row_k)
        return oinv.insert_unordered(st, col, u, v), g, ca

    return lax.cond(state.mask[col], rm, ins, state, gk, c_act, u1, vtv)


def _update_direction(inv_state: oinv.InverseState, c, tol, n, dtype):
    """direction = expand(inv · sign(c_Γ)) — gather/sign/gemv/scatter.

    Reference: homotopy-cpu.cpp:257-266 (vec_subset → sign → gemv → expand).
    """
    cg = jnp.take(c, inv_state.indices, mode="fill", fill_value=0)
    cg = _sign_deadzone(cg, tol)
    ds = blas.xgemv(inv_state.inv, cg)
    return jnp.zeros((n,), dtype).at[inv_state.indices].set(ds, mode="drop")


def solve_homotopy(A: jnp.ndarray, y: jnp.ndarray, tolerance,
                   max_iterations: int, k_max: int, *,
                   mode: str = "fast", sparse_matvec: bool = False):
    """Run the homotopy solver on a dense on-device A;
    returns (x, HomotopyReportArrays). jit/vmap-safe; ``max_iterations``,
    ``k_max`` (active-set capacity), ``mode`` and ``sparse_matvec`` are
    static."""
    return solve_homotopy_core(DenseOperator(A), A.shape[1], y, tolerance,
                               max_iterations, k_max, mode=mode,
                               sparse_matvec=sparse_matvec)


def solve_homotopy_core(op, n: int, y: jnp.ndarray, tolerance,
                        max_iterations: int, k_max: int, *,
                        mode: str = "fast", sparse_matvec: bool = False,
                        use_gk: bool = False, record_path: bool = False,
                        compact: bool = False):
    """Homotopy path loop over an abstract sensing operator.

    ``op`` supplies matvec/rmatvec/gram_column (ops/operators.py) — dense on
    one device, or a row-shard with psum reductions inside shard_map. ``n``
    is the global column count (static).

    ``use_gk`` (static) switches the fast-mode direction update to the
    slot-space Gram-companion recurrence instead of the correlation
    gather; measured slower under vmap on the previous accelerator
    (docs/design.md §8) and kept as the formulation the slot-space
    batch driver uses (ops/slot.transition).

    ``record_path`` (static) additionally records the LARS/LASSO
    regularization path the loop already follows: after breakpoint t the
    iterate x_t minimizes ½‖y−Ax‖² + λ_t‖x‖₁ with λ_t = ‖Aᵀ(y−Ax_t)‖∞
    (the loop's own c_inf). The history is kept compactly in slot space
    ((max_iterations+1, k_max) values + indices and the λ sequence) and
    returned as a third element: (x, report, (hist_v, hist_i, hist_l)).
    No reference analog — its loop visits the same breakpoints but only
    returns the endpoint (homotopy-cpu.cpp:274).

    ``compact`` (static, exclusive with record_path's third element)
    returns ((values, indices), report) — the k_max-slot active-set
    solution with sentinel index n — instead of the dense (n,) x; the
    north-star CSR-style output (api solve_batch dense=False).
    """
    if mode not in ("fast", "exact"):
        raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
    fast = mode == "fast"
    dtype = op.dtype
    tol = jnp.asarray(tolerance, dtype)

    x0 = jnp.zeros((n,), dtype)

    # --- init (reference: homotopy-cpu.cpp:215-229); x0 = 0 so the
    # residual correlation reduces to c0 = Aᵀy exactly ---
    c0 = op.rmatvec(y)
    idx0 = jnp.argmax(jnp.abs(c0))
    c_inf0 = jnp.abs(c0[idx0])

    empty_set = oinv.init(k_max, n, dtype)
    if fast:
        u1_0, vtv_0 = op.gram_gathered(idx0, empty_set.indices)
        inv0 = oinv.insert_unordered(empty_set, idx0, u1_0, vtv_0)
    else:
        u1_0, vtv_0 = op.gram_column(idx0)
        inv0 = oinv.insert(empty_set, idx0, u1_0, vtv_0)

    # initial direction: sign(c_inf) * inv[0,0] scattered to idx0 —
    # note sign of the *norm*, not of c[idx0] (homotopy-cpu.cpp:223-227)
    cg0 = _sign_deadzone(c_inf0, tol)
    ds0 = cg0 * inv0.inv[0, 0]
    d0 = jnp.zeros((n,), dtype).at[idx0].set(ds0)
    if fast and use_gk:
        gk0 = jnp.zeros((k_max, k_max), dtype).at[0, 0].set(vtv_0)
        c_act0 = jnp.zeros((k_max,), dtype).at[0].set(c0[idx0])
        d_act0 = jnp.zeros((k_max,), dtype).at[0].set(ds0)
    else:  # 1-element dummies: the pytree slot exists, the machinery off
        gk0 = jnp.zeros((1, 1), dtype)
        c_act0 = jnp.zeros((1,), dtype)
        d_act0 = jnp.zeros((1,), dtype)

    if record_path:
        # row 0 = the λ-max end of the path (x = 0, λ0 = ‖Aᵀy‖∞)
        hist_v0 = jnp.zeros((max_iterations + 1, k_max), dtype)
        hist_i0 = jnp.full((max_iterations + 1, k_max), n, jnp.int32)
        hist_l0 = jnp.zeros((max_iterations + 1,), dtype).at[0].set(c_inf0)
    else:  # pytree-shaped dummies, machinery off
        hist_v0 = jnp.zeros((1, 1), dtype)
        hist_i0 = jnp.zeros((1, 1), jnp.int32)
        hist_l0 = jnp.zeros((1,), dtype)

    init = _LoopState(
        it=jnp.uint32(0), x=x0, c=c0, c_inf=c_inf0, direction=d0,
        inv=inv0, gk=gk0, c_act=c_act0, d_act=d_act0,
        broke=jnp.bool_(False),
        hist_v=hist_v0, hist_i=hist_i0, hist_l=hist_l0,
    )

    def compute_q(s: _LoopState):
        """q = AᵀA d (homotopy-cpu.cpp:111-120)."""
        if fast and sparse_matvec and op.has_gram:
            return op.gram_matvec_sparse(s.direction, s.inv.indices)
        if fast and sparse_matvec:
            return op.rmatvec(op.matvec_sparse(s.direction, s.inv.indices))
        return op.rmatvec(op.matvec(s.direction))

    def body(s: _LoopState) -> _LoopState:
        it = s.it + 1

        q = compute_q(s)
        gamma, idx = _find_max_gamma(q, s.c, s.x, s.direction, s.c_inf,
                                     s.inv.mask, dtype)

        present = s.inv.mask[idx]
        # This toggle empties the active set iff it removes the only
        # member (homotopy-cpu.cpp:248-249). Clamping such a lane's step
        # to zero freezes its x/c in place — the reference breaks before
        # touching them — without any per-field keep-selects at the end
        # of the body.
        empty = present & (s.inv.k == 1)
        if k_max <= max_iterations:
            # a user-shrunk capacity can overflow (the default
            # max_iterations+1 cannot: ≤1 insert per iteration); treat a
            # full-capacity insert like the empty-set break instead of
            # writing out of bounds
            empty = empty | (~present & (s.inv.k >= k_max))
        if fast:
            # degenerate-insert guard (fast mode only; exact mode keeps
            # the reference's unguarded arithmetic op-for-op): when the
            # support nears rank deficiency the insert's Schur complement
            # den = vᵀv − u1ᵀBu1 is rounding noise and the reference's
            # 1/den (online_inverse.h:219) degenerates to inf/NaN —
            # break instead, solution intact (same rule and threshold as
            # the batch driver's transition kernel).
            u1g, vtvg = op.gram_gathered(idx, s.inv.indices)
            den = vtvg - blas.xdot(u1g, blas.xgemv(s.inv.inv, u1g))
            # narrowest guard that keeps 1/den finite: |den| above
            # subnormal scale. Tiny and even negative dens proceed
            # exactly as the reference's arithmetic does (coherent
            # dictionaries produce noise-level dens whose paths still
            # converge via the per-iteration sign recomputation).
            tiny = jnp.asarray(256 * jnp.finfo(dtype).tiny, dtype)
            empty = empty | (~present & (jnp.abs(den) <= tiny))
            # a broken lane's toggle still executes under vmap's batched
            # while_loop — feed it a virtual orthogonal column (u1 = 0,
            # vᵀv = 1) so no 1/0 enters the carried inverse
            u1g = jnp.where(empty, jnp.array(0, dtype), u1g)
            vtvg = jnp.where(empty, jnp.array(1, dtype), vtvg)
        gamma = jnp.where(empty, jnp.array(0, dtype), gamma)

        if fast and use_gk:
            u1, vtv = u1g, vtvg
            # active correlations advance by the same recurrence as c,
            # restricted to the support: q[Γ] = (AᵀA)[Γ,Γ] d[Γ] exactly
            # (d is supported on Γ), with the small Gram submatrix
            # maintained incrementally — no gather from the n-vector.
            q_act = blas.xgemv(s.gk, s.d_act)
            c_act1 = s.c_act - gamma * q_act
            inv1, gk1, c_act1 = _toggle_support_unordered(
                s.inv, s.gk, c_act1, idx, u1, vtv)
        elif fast:
            u1, vtv = u1g, vtvg
            inv1 = lax.cond(
                s.inv.mask[idx],
                lambda st, _u, _v: oinv.remove_unordered(st, idx),
                lambda st, u, v: oinv.insert_unordered(st, idx, u, v),
                s.inv, u1, vtv)
            gk1, c_act1 = s.gk, s.c_act  # pass-through (unused, aliased)
        else:
            u1, vtv = op.gram_column(idx)
            inv1 = _toggle_support(s.inv, idx, u1, vtv)
            gk1, c_act1, d_act1 = s.gk, s.c_act, s.d_act

        x1 = s.x + gamma * s.direction
        if fast:
            # c(x + γd) = c(x) − γ·AᵀAd — recurrence instead of the two
            # residual gemvs at homotopy-cpu.cpp:255
            c1 = s.c - gamma * q
            if use_gk:
                # newly inserted slot's correlation: one scalar from c1
                c_act1 = jnp.where(present, c_act1,
                                   c_act1.at[s.inv.k].set(c1[idx]))
                cg = c_act1
            else:
                cg = jnp.take(c1, inv1.indices, mode="fill", fill_value=0)
            # direction = B·sign(c_Γ) computed wholly in slot space
            # (homotopy-cpu.cpp:257-266 without the vec_subset gather)
            ds = blas.xgemv(inv1.inv, _sign_deadzone(cg, tol))
            d_act1 = ds if use_gk else s.d_act
            d1 = jnp.zeros((n,), dtype).at[inv1.indices].set(ds,
                                                             mode="drop")
        else:
            c1 = op.rmatvec(y - op.matvec(x1))
            d1 = _update_direction(inv1, c1, tol, n, dtype)
        c_inf1 = jnp.max(jnp.abs(c1))

        c_inf_out = jnp.where(empty, s.c_inf, c_inf1)
        if record_path:
            row = jnp.int32(it)
            # a break iteration (empty) commits nothing: γ was clamped to
            # 0 and the reference breaks BEFORE touching the support —
            # but the toggle above already ran (vmap executes both
            # sides), so the recorded row must come from the PRE-toggle
            # support. It then duplicates the previous breakpoint
            # exactly; solve_path trims the trailing duplicate.
            rec_idx = jnp.where(empty, s.inv.indices, inv1.indices)
            vals = jnp.take(x1, rec_idx, mode="fill", fill_value=0)
            hist_v = lax.dynamic_update_slice(s.hist_v, vals[None, :],
                                              (row, jnp.int32(0)))
            hist_i = lax.dynamic_update_slice(s.hist_i,
                                              rec_idx[None, :],
                                              (row, jnp.int32(0)))
            hist_l = lax.dynamic_update_slice(
                s.hist_l, c_inf_out[None], (row,))
        else:
            hist_v, hist_i, hist_l = s.hist_v, s.hist_i, s.hist_l

        return _LoopState(
            it=it,
            x=x1,
            c=c1,
            c_inf=c_inf_out,
            direction=d1,
            inv=inv1,
            gk=gk1,
            c_act=c_act1,
            d_act=d_act1,
            broke=empty,
            hist_v=hist_v, hist_i=hist_i, hist_l=hist_l,
        )

    def cond(s: _LoopState):
        # do-while: the body always runs at least once (homotopy-cpu.cpp:236)
        return (s.it == 0) | (
            (~s.broke) & (s.it < jnp.uint32(max_iterations)) & (s.c_inf > tol)
        )

    final = lax.while_loop(cond, body, init)
    report = HomotopyReportArrays(iter=final.it, solution_error=final.c_inf)
    if record_path:
        return final.x, report, (final.hist_v, final.hist_i, final.hist_l)
    if compact:
        # slot-space solution (values at active indices, sentinel n) —
        # the loop's own active-set state, so scatter(values, indices)
        # reproduces final.x exactly (api solve_batch dense=False)
        vals = jnp.take(final.x, final.inv.indices, mode="fill",
                        fill_value=0)
        return (vals, final.inv.indices), report
    return final.x, report
