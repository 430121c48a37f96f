"""Batch-native OMP driver — one-pass greedy pursuit over lanes.

The vmapped OMP core (solvers/omp.py) at the throughput shape is
gemm-dominated at 3-pass precision and loop-state-dominated at one
pass; this driver is the slot-space batch formulation (the homotopy
batch driver's playbook, solvers/homotopy_batch.py) for the one-pass
regime:

  * the correlation product c = c₀ − AᵀA x̂ is the shared q product
    (homotopy_batch.make_qprod: two bf16 gemms on a bf16 copy of A in
    the one-pass regime);
  * the insert + LS re-solve is elementwise work over the (b,K,K)
    inverse (ops/slot.omp_insert), updated in place in the loop carry;
  * all slot state is incremental: OMP only inserts, so A_Γᵀy grows by
    one gathered scalar per pick (c₀ is computed once at HIGHEST
    precision — it is every LS right-hand side and the rss identity's
    dominant noise term) and membership is one scattered mask byte;
  * per-lane ‖r‖² uses the LS identity ‖y‖² − (A_Γᵀy)ᵀx_Γ in-loop (its
    rounding floor only affects *when* a lane stops — the stall
    detector bounds it), and the REPORTED error is a final HIGHEST-
    precision certificate ‖y − Ax‖₂ computed once outside the loop from
    the returned solution — the homotopy "certified" pattern
    (docs/design.md §3) applied to the greedy family.

With a precomputed Gram the per-pick insert column is one G-row
gather; ``G=None`` runs **gram-free** (the config-5 regime: n too
large for an n² table) — the K live entries are computed directly per
pick, the homotopy driver's gram_u1 design. f32 only. The api routes
here by the homotopy driver's rule (homotopy_batch.route_batch_native);
everything else keeps the vmapped core.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax as _lax

from ..ops import blas
from ..ops import slot as _slot
from .omp import OmpReportArrays


class _OBState(NamedTuple):
    it: jnp.ndarray       # (b,) uint32
    c: jnp.ndarray        # (b, n) residual correlations
    mask: jnp.ndarray     # (b, n) int8 membership
    inv: jnp.ndarray      # (b, K, K)
    b_act: jnp.ndarray    # (b, K) A_Γᵀy in slot order
    coef: jnp.ndarray     # (b, K) LS coefficients
    indices: jnp.ndarray  # (b, K) int32, sentinel n
    kk: jnp.ndarray       # (b,) int32 live size
    rss: jnp.ndarray      # (b,) ‖r‖² (identity form)
    broke: jnp.ndarray    # (b,) degenerate pick — stop, state reverted
    done: jnp.ndarray     # (b,) rss stalled — stop, iterate kept


def _embed_omp(s: _OBState, K2: int, n: int) -> _OBState:
    """Zero-pad a capacity-K1 state into capacity K2 (> K1) at a tier
    boundary (homotopy_batch._embed's design): exact, because padded
    slots carry the sentinel index and zero inverse rows/columns, which
    the insert and the slot reductions treat as absent."""
    K1 = s.b_act.shape[1]
    p = K2 - K1
    pad2 = lambda a: jnp.pad(a, ((0, 0), (0, p)))
    return _OBState(
        it=s.it, c=s.c, mask=s.mask,
        inv=jnp.pad(s.inv, ((0, 0), (0, p), (0, p))),
        b_act=pad2(s.b_act), coef=pad2(s.coef),
        indices=jnp.pad(s.indices, ((0, 0), (0, p)), constant_values=n),
        kk=s.kk, rss=s.rss, broke=s.broke, done=s.done)


def solve_omp_batch(A: jnp.ndarray, G: jnp.ndarray, Y: jnp.ndarray,
                    tolerance, max_iterations: int, k_max: int,
                    axis: str | None = None,
                    dense: bool = True,
                    overlap_blocks: int = 1,
                    ladder: bool | None = None,
                    overlap_mode: str = "psum",
                    axis_size: int | None = None,
                    sync_axes: tuple | None = None,
                    picks: int = 1):
    """Batched greedy solve; returns (X (b, n), OmpReportArrays).

    ``axis`` names a row-shard psum axis when run inside shard_map (A
    and Y row-sharded, G replicated — the homotopy driver's layout).

    ``ladder`` controls the capacity-tier ladder (None = auto, the
    homotopy driver's shared ``_plan_tiers`` rule): early picks run in
    reduced-capacity loops — the (b,K,K) insert/LS update, the (b,K)
    slot gathers and the rss reduction are capacity-proportional and
    otherwise paid for provably-empty slots — with one exact zero-pad
    embed per boundary.

    ``dense=False`` skips the final (b, n) scatter and returns the
    driver's own compact slot-space solution ``((values, indices),
    report)`` — values (b, k_max) at columns indices (b, k_max),
    sentinel ``n`` for empty slots (the homotopy driver's north-star
    CSR form, solvers/homotopy_batch.py). The high-precision residual
    certificate still densifies *locally on device* — the saving of
    the compact form is the (b, n) device→host transfer.

    ``overlap_blocks`` > 1 (sharded only) splits each pick's
    q = AᵀA D into that many independent column-block products, each
    ending in its own ``psum``, so block j's all-reduce overlaps block
    j+1's local gemm (the homotopy driver's north-star overlap,
    solvers/homotopy_batch.py). Exact: identical local-row dots and
    psum trees per element.

    ``overlap_mode="ppermute"`` (sharded only; ``axis_size`` = row-axis
    device count) hand-pipelines the q reduction as the collective-
    matmul ring of ``make_qprod`` — chained ``lax.ppermute`` steps
    interleaved with the local block gemms, immune to XLA's all-reduce
    combiner (docs/design.md §9); ring summation order differs from
    the psum tree by f32 ulps.

    ``picks`` (static, ≥ 1): generalized-OMP rounds in the driver —
    each round selects the ``picks`` largest inactive correlations per
    lane (iterated masked argmax), runs that many guarded insert/LS
    updates (each O(b·K²), cheap), and pays ONE q = AᵀA x̂ correlation
    pass. The q pass is the driver's dominant per-pick cost, so a
    k-sparse recovery costs ~k/picks of it. Degenerate sub-inserts are skipped individually; a
    lane whose round commits nothing breaks with its solution intact.
    ``max_iterations`` stays the COLUMN budget (iter = support size).
    picks=1 is the existing trajectory, bit-for-bit. A capacity-tier
    boundary may split a round (lanes freeze mid-round at the tier's
    column cap and resume in the next tier's loop): equivalent to one
    shorter round followed by a fresh greedy selection on the updated
    correlations — a legitimate gOMP trajectory that can differ from
    the single-loop core's at the boundary (support quality is the
    tested contract there, as with the homotopy ladder).
    """
    b, _ = Y.shape
    n = A.shape[1]
    K = k_max
    dtype = A.dtype
    if dtype != jnp.float32:
        raise ValueError(
            "the batch-native OMP driver is float32; "
            f"got {dtype} — the api routes f64 to the vmapped core")
    if overlap_blocks > 1 and axis is None:
        raise ValueError(
            "overlap_blocks splits the sharded q psum into column-block "
            "collectives; without a shard axis there is no psum to "
            "overlap — pass axis=... or overlap_blocks=1")
    if b == 0:
        # empty batch: nothing to solve
        report = OmpReportArrays(iter=jnp.zeros((0,), jnp.uint32),
                                 solution_error=jnp.zeros((0,), dtype))
        out = (jnp.zeros((0, n), dtype) if dense else
               (jnp.zeros((0, K), dtype), jnp.full((0, K), n, jnp.int32)))
        return out, report
    tol = jnp.asarray(tolerance, dtype)
    bidx = jnp.arange(b)
    psum = (lambda v: _lax.psum(v, axis)) if axis is not None else (
        lambda v: v)

    # c₀ at HIGHEST precision: it is the rhs of every LS re-solve (b_act
    # gathers from it) AND the dominant noise term of the in-loop rss
    # identity ‖y‖² − b_actᵀx̂ — a reduced-precision c₀'s absolute noise
    # δ inflates the identity's floor to ~2·δ·Σ|x̂|, which can sit at
    # tol² and cost a spurious pick per lane. C0 is one gemm per SOLVE,
    # so its cost is amortized to nothing.
    with blas.precision_scope("highest"):
        C0 = psum(blas.xgemm(Y, A))
    yty = psum(jnp.sum(Y * Y, axis=1))
    # exact f32 column norms: feed the insert's degeneracy guard either
    # way (the Gram diagonal, or computed directly when gram-free)
    gdiag = jnp.diagonal(G) if G is not None else psum(
        jnp.sum(A * A, axis=0))

    # q product and gram-free insert column from the factories shared
    # with the homotopy driver (solvers/homotopy_batch.py — extracted so
    # the copies cannot drift): bf16 gemms on the one-pass route,
    # float32 gemms at high/highest, column-block psums when
    # overlapped
    from .homotopy_batch import (_plan_tiers, gram_slot_gather,
                                 make_gram_u1, make_qprod, synced_while)
    qprod, bf16_q, A16 = make_qprod(A, psum, overlap_blocks, None, n,
                                     overlap_mode=overlap_mode,
                                     axis=axis, axis_size=axis_size)
    if G is None:
        gram_u1 = make_gram_u1(A, A16, bf16_q, psum, dtype)

    def make_tier(K: int, it_cap: int | None):
        """(init, body, lane_live) at capacity K. ``it_cap`` freezes
        lanes at the capacity-ladder phase boundary (they resume
        unchanged in the next tier's loop — homotopy's _plan_tiers
        design: with ≤1 insert per committed iteration, kk ≤ it, so a
        lane capped at it < K−1 can never touch slot K−1)."""

        init = _OBState(
            it=jnp.zeros(b, jnp.uint32),
            c=C0,
            mask=jnp.zeros((b, n), jnp.int8),
            inv=jnp.zeros((b, K, K), dtype),
            b_act=jnp.zeros((b, K), dtype),
            coef=jnp.zeros((b, K), dtype),
            indices=jnp.full((b, K), n, jnp.int32),
            kk=jnp.zeros(b, jnp.int32),
            rss=yty,
            broke=jnp.zeros(b, bool),
            done=jnp.zeros(b, bool),
        )

        def lane_live(s: _OBState):
            live = ((~s.broke) & (~s.done)
                    & (s.it < jnp.uint32(max_iterations))
                    & (s.kk < K)
                    & (jnp.maximum(s.rss, 0) > tol * tol))
            if it_cap is not None:
                live = live & (s.it < jnp.uint32(it_cap))
            return live

        def body(s: _OBState) -> _OBState:
            live = lane_live(s)

            scores = jnp.where(s.mask > 0, jnp.array(-1, dtype),
                               jnp.abs(s.c))
            if picks == 1:
                # greedy pick over the inactive set (leftmost argmax)
                idx = jnp.argmax(scores, axis=1).astype(jnp.int32)

                # insert column from one streaming G-row gather + the
                # aligned-block slot extraction (homotopy_batch.
                # gram_slot_gather); gram-free, the K live entries
                # computed directly
                if G is not None:
                    u1, vtv = gram_slot_gather(G, idx, s.indices, n)
                else:
                    u1 = gram_u1(idx, s.indices)
                    vtv = jnp.take(gdiag, idx)

                # the LS rhs grows by one gathered scalar of c₀
                bnew = jnp.take_along_axis(C0, idx[:, None],
                                           axis=1)[:, 0]
                b_act1 = jnp.where(live[:, None],
                                   s.b_act.at[bidx, s.kk].set(bnew),
                                   s.b_act)

                inv1, coef1, deg = _slot.omp_insert(
                    s.inv, u1, s.kk, vtv, b_act1, live)
                stepped = live & ~deg
                ncommit = stepped.astype(jnp.uint32)
                it1 = jnp.where(stepped, s.it + 1, s.it)
                kk1 = jnp.where(stepped, s.kk + 1, s.kk)
                broke_round = live & deg

                ind1 = jnp.where(stepped[:, None],
                                 s.indices.at[bidx, s.kk].set(idx),
                                 s.indices)
                mask1 = jnp.where(stepped[:, None],
                                  s.mask.at[bidx, idx].set(1), s.mask)
            else:
                # gOMP round: the picks largest inactive scores per
                # lane — selected by ITERATED masked argmax (identical
                # to top_k's descending/leftmost order; chosen over
                # lax.top_k on the previous accelerator, awaiting an
                # A/B on the GPU, ROADMAP queue 1 #5) — inserted by
                # sequential guarded updates; each sub-insert's u1
                # gather sees the grown support. ONE q pass follows.
                inv1, b_act1 = s.inv, s.b_act
                ind1, mask1 = s.indices, s.mask
                kk1, it1 = s.kk, s.it
                coef1 = s.coef
                ncommit = jnp.zeros(b, jnp.uint32)
                sc = scores
                for j in range(picks):
                    idx = jnp.argmax(sc, axis=1).astype(jnp.int32)
                    val = jnp.take_along_axis(sc, idx[:, None],
                                              axis=1)[:, 0]
                    sc = sc.at[bidx, idx].set(jnp.array(-1, dtype))
                    # strictly positive correlation (the oracle's
                    # degenerate-round semantics — review finding)
                    elig = (live & (val > 0)
                            & (kk1 < K)
                            & (it1 < jnp.uint32(max_iterations)))
                    if it_cap is not None:
                        elig = elig & (it1 < jnp.uint32(it_cap))
                    if G is not None:
                        u1, vtv = gram_slot_gather(G, idx, ind1, n)
                    else:
                        u1 = gram_u1(idx, ind1)
                        vtv = jnp.take(gdiag, idx)
                    bnew = jnp.take_along_axis(C0, idx[:, None],
                                               axis=1)[:, 0]
                    b_act_j = jnp.where(elig[:, None],
                                        b_act1.at[bidx, kk1].set(bnew),
                                        b_act1)
                    inv1, coef_j, deg = _slot.omp_insert(
                        inv1, u1, kk1, vtv, b_act_j, elig)
                    ok = elig & ~deg
                    ind1 = jnp.where(ok[:, None],
                                     ind1.at[bidx, kk1].set(idx), ind1)
                    mask1 = jnp.where(ok[:, None],
                                      mask1.at[bidx, idx].set(1), mask1)
                    b_act1 = jnp.where(ok[:, None], b_act_j, b_act1)
                    coef1 = jnp.where(ok[:, None], coef_j, coef1)
                    kk1 = jnp.where(ok, kk1 + 1, kk1)
                    it1 = jnp.where(ok, it1 + 1, it1)
                    ncommit = ncommit + ok.astype(jnp.uint32)
                stepped = live & (ncommit > 0)
                broke_round = live & (ncommit == 0)

            # ‖r‖² by the LS identity (in-loop stop only; the reported error
            # is the post-loop high-precision certificate)
            rss1 = yty - jnp.sum(b_act1 * coef1, axis=1)

            # correlation update from the new coefficients
            D = jnp.zeros((b, n), dtype).at[bidx[:, None], ind1].set(
                jnp.where(stepped[:, None], coef1, 0), mode="drop")
            q = qprod(D)
            c1 = jnp.where(stepped[:, None], C0 - q, s.c)

            # a finite-state guard in the driver regime: a blown lane stops
            # with its previous committed state
            blew = stepped & ~(jnp.isfinite(coef1).all(axis=1)
                               & jnp.isfinite(rss1))
            stepped = stepped & ~blew

            keep = lambda new, old: jnp.where(stepped[:, None], new, old)
            return _OBState(
                it=jnp.where(stepped, it1, s.it),
                c=keep(c1, s.c),
                mask=keep(mask1, s.mask),
                # inv1 commits ungated so the carry updates in place (a
                # where over s.inv would keep the old buffer live and add
                # a (b,K,K) copy per pick): inert/degenerate lanes already
                # get inv1 == inv bit-exact from omp_insert's gate, and a
                # blown lane's inverse is never observable again (it
                # breaks; committed coef/indices stay reverted)
                inv=inv1,
                b_act=keep(b_act1, s.b_act),
                coef=keep(coef1, s.coef),
                indices=keep(ind1, s.indices),
                kk=jnp.where(stepped, kk1, s.kk),
                # strictly-decreasing contract: a stall marks the identity's
                # rounding floor (solvers/omp.py) — stop, iterate kept
                rss=jnp.where(stepped, rss1, s.rss),
                broke=s.broke | broke_round | blew,
                done=s.done | (stepped & (rss1 >= s.rss)),
            )


        return init, body, lane_live

    # capacity-tier ladder (homotopy's _plan_tiers, shared planner): the
    # insert/LS update, the u1 slot gather and the (b,K) state are all
    # capacity-proportional and otherwise paid for provably-empty slots
    # during the early picks; run them at reduced capacity and zero-pad
    # the state upward at each boundary (exact — padded slots hold the
    # sentinel index and zero rows, which the insert treats as absent)
    tiers = _plan_tiers(k_max, max_iterations, ladder)
    state = None
    for t, Kt in enumerate(tiers):
        cap = None if t == len(tiers) - 1 else Kt - 1
        init, body, lane_live = make_tier(Kt, cap)
        st = init if state is None else _embed_omp(state, Kt, n)
        state = synced_while(body, lane_live, st, sync_axes)
    final = state

    X = jnp.zeros((b, n), dtype).at[bidx[:, None], final.indices].set(
        final.coef, mode="drop")
    # final certificate: ‖y − Ax‖₂ per lane at HIGHEST precision — the
    # value a high-precision solve would report for this support
    with blas.precision_scope(blas.PARITY):
        # rows stay local when sharded; the squared norm psums like
        # every other m-axis reduction (identity psum unsharded)
        R = Y - blas.xgemm(X, A, trans_b=True)
        err = jnp.sqrt(jnp.maximum(psum(jnp.sum(R * R, axis=1)), 0))
    report = OmpReportArrays(iter=final.it, solution_error=err)
    if not dense:
        return (final.coef, final.indices), report
    return X, report
