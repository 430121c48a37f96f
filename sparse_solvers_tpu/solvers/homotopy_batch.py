"""Batch-native homotopy driver — the slot-space throughput path.

Semantically equivalent to ``jax.vmap(solve_homotopy)`` in fast mode (same
path decisions, same per-lane do-while/freeze semantics), restructured so
that each iteration is a few whole-batch operations instead of the
vmapped core's per-lane gathers and (b, n) candidate arrays:

  * **slot-space state**: x, the direction and the active correlations
    live as (b, k_max) arrays; the only (b, n) carries are the
    correlation c and an int8 membership mask. x is scattered to (b, n)
    once, after the loop.
  * **γ scan** (ops/slot.find_max_gamma): the candidate formula and one
    (min, leftmost position) reduction over q and c.
  * **transition** (ops/slot.transition): insert/remove on the padded
    inverse, slot bookkeeping and the direction matvec as elementwise
    work over the (b, K, K) state.
  * the q = AᵀA·d product: two gemms, on a bf16 copy of A in the
    one-pass regime (make_qprod); the Gram-row fetch and one (b, k_max)
    gather for the insert's Gram column u1.
  * **capacity tier ladder** (_plan_tiers): the early path runs in a
    reduced-capacity loop (after i iterations at most i+1 slots can be
    live), so the (b,K) u1 gather, the (b,K) direction scatter and the
    (b,K,K) transition are not paid for provably-empty slots; one
    zero-pad embed migrates the state to the full-capacity loop.

Sign semantics: the reference recomputes sign(c_Γ) with a tolerance
deadzone every iteration (reference: src/solvers/homotopy-cpu.cpp:
257-266, :59-67) — and must: this variant's γ-candidate list does not
bound γ by λ, so on noisy paths an active correlation can cross zero
between support changes (carrying insert-time signs was measured to
diverge exactly there). The transition therefore maintains the
active correlation *values* in slot space by the recurrence
c_act ← c_act − γ·(AᵀA)[Γ,Γ]·d_act — algebraically identical to
gathering c[Γ], gather-free — and takes deadzone-signs from them. The
initial direction uses the reference's sign(‖c‖∞)=+1 quirk
(homotopy-cpu.cpp:223-227). Iteration counts match the vmapped core
exactly on well-conditioned workloads (tests/test_batch_native.py); on
near-degenerate thrashy problems the trajectories may fork at an
ulp-level candidate tie — the same class of divergence the core shows
between matmul precision levels — and the tests assert oracle-quality
recovery there instead.

Lane lifecycle: a lane is live while the reference's do-while condition
holds for it (homotopy-cpu.cpp:236); frozen lanes keep their state
through explicit selects (never 0·NaN blends — round-1 advisor finding).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from jax import lax as _lax

from ..ops import blas
from ..ops import slot as _slot
from .homotopy import HomotopyReportArrays, _sign_deadzone


class _BState(NamedTuple):
    it: jnp.ndarray        # (b,) uint32 per-lane iteration count
    c: jnp.ndarray         # (b, n) correlations
    c_inf: jnp.ndarray     # (b,)
    mask: jnp.ndarray      # (b, n) int8 support membership
    inv: jnp.ndarray       # (b, K, K) padded (A_ΓᵀA_Γ)⁻¹
    gk: jnp.ndarray        # (b, K, K) active Gram submatrix (AᵀA)[Γ,Γ]
    x_act: jnp.ndarray     # (b, K) solution over slots
    d_act: jnp.ndarray     # (b, K) direction over slots
    c_act: jnp.ndarray     # (b, K) active correlations c[Γ] (recurrence)
    indices: jnp.ndarray   # (b, K) int32, sentinel n
    kk: jnp.ndarray        # (b,) int32 live slot count
    broke: jnp.ndarray     # (b,) bool


def _take1(M, idx):
    """M[lane, idx[lane]] → (b,)."""
    return jnp.take_along_axis(M, idx[:, None], axis=1)[:, 0]


def on_gpu() -> bool:
    """The slot-space drivers' one platform question, asked by
    ``route_batch_native`` and ``make_qprod``: is the default device a
    GPU? There the driver is the throughput route and the DEFAULT-
    precision q product runs on a bf16 copy of A (tensor-core bf16 at
    half the bytes of the float32 operand). On the CPU, XLA computes
    every float32 product in full float32, so neither choice pays."""
    return jax.default_backend() == "gpu"


def route_batch_native(lanes: int | None, dtype, sparse: bool) -> bool:
    """THE routing rule for the slot-space drivers, shared by
    ``Homotopy._plan``, ``Omp``, ``homotopy_sharded`` and ``omp_sharded``
    so the copies cannot drift.

    Structural requirements: a positive lane count and float32 (the
    bf16 one-pass q product and the drivers' tests are float32; f64
    keeps the vmapped core). ``SS_BATCH_NATIVE=1`` forces the driver
    wherever those hold; ``=0`` forbids it. The auto default takes the
    driver on a GPU outside the ``sparse`` regime the caller computed
    (where the gather-based vmapped core's traffic is below two passes
    over A per product)."""
    import os

    import numpy as _np

    if not (lanes is not None and lanes > 0
            and _np.dtype(dtype) == _np.float32):
        return False
    env = os.environ.get("SS_BATCH_NATIVE")
    if env in ("0", "1"):
        return env == "1"
    return not sparse and on_gpu()


def make_qprod(A, psum, overlap_blocks: int, bf16_q: bool | None, n: int,
               overlap_mode: str = "psum", axis: str | None = None,
               axis_size: int | None = None):
    """Shared q = AᵀA D product factory for the slot-space batch drivers
    (homotopy and OMP — extracted so the copies cannot drift, like
    ``route_batch_native``). Returns ``(qprod, bf16_q, A16)``.

    ``bf16_q`` selects the one-pass bf16 product: both gemms read a bf16
    copy A16 of A with float32 accumulation (ops/slot.gemm_bf16, the
    form of ops/slot.normal_matvec_bf16), in every form below. None =
    auto: on at DEFAULT precision on a GPU (``on_gpu``). Off, the
    float32 gemms honor the traced precision.
    ``overlap_blocks`` > 1 splits the second gemm into
    independently-psum'd column blocks: block j's all-reduce has no
    data dependence on block j+1's local gemm, so an async-capable
    scheduler can hide each psum behind the next block's gemm. Exact:
    every q element is the same local-row dot followed by the same psum
    reduction tree as the unsplit form. XLA's all-reduce combiner may
    re-merge the S independent all-reduces into one variadic all-reduce
    and so decline the offered overlap (docs/design.md §9), which is
    what ``overlap_mode="ppermute"`` exists to avoid.

    ``overlap_mode="ppermute"`` (sharded only) hand-pipelines the
    reduction as a collective-matmul ring (the scaling-book pattern the
    combiner cannot touch): q's columns split into S = axis_size
    chunks; at ring step t each device computes its LOCAL partial for
    chunk ((i−t) mod S) and accumulates it into the chunk arriving from
    its ring predecessor, then ``lax.ppermute``s the running sum
    onward. The S−1 permutes are chained through distinct data (no
    combiner can merge them) and each is dataflow-independent of the
    NEXT step's local gemm, so the transfer can run behind that gemm.
    After S steps device i holds the fully-reduced chunk (i+1) mod S;
    one all_gather rebuilds q. Wire bytes equal the ring all-reduce's
    reduce-scatter phase + gather phase — no extra traffic.
    Algebraically exact (every element is the same set of per-shard
    partial dots); the ring fixes the summation order to ring-visit
    order, which may differ from the psum tree's by f32-rounding ulps —
    covered by the certified error path (tests pin trajectory +
    solution parity on the virtual mesh)."""
    if overlap_mode not in ("psum", "ppermute"):
        raise ValueError(
            f"overlap_mode must be 'psum' or 'ppermute', got {overlap_mode!r}")
    if overlap_mode == "ppermute":
        if axis is None or not axis_size or axis_size < 2:
            raise ValueError(
                "overlap_mode='ppermute' ring-pipelines the row-shard "
                "reduction; it needs axis=... with axis_size >= 2 "
                f"(got axis={axis!r}, axis_size={axis_size})")
        if overlap_blocks > 1:
            raise ValueError(
                "overlap_blocks is the psum-mode knob; the ppermute ring "
                "always uses S = axis_size chunks")
    if bf16_q is None:
        bf16_q = default_bf16_q()
    A16 = A.astype(jnp.bfloat16) if bf16_q else None
    # every form reads the same operand with the same gemm, so the
    # sharded forms round exactly as the unsharded one does
    B = A16 if bf16_q else A
    mm = _slot.gemm_bf16 if bf16_q else blas.xgemm

    if overlap_mode == "ppermute":
        S = axis_size
        blk = -(-n // S)
        npad = S * blk
        perm = [(s, (s + 1) % S) for s in range(S)]
        Bp = jnp.pad(B, ((0, 0), (0, npad - n))) if npad != n else B

        def qprod(D):
            p = mm(D, B, trans_b=True)              # (b, m_local) local
            my = _lax.axis_index(axis)
            acc = None
            for t in range(S):
                j = (my - t) % S                    # this step's chunk
                Bblk = _lax.dynamic_slice_in_dim(Bp, j * blk, blk, axis=1)
                contrib = mm(p, Bblk)               # local partial (b, blk)
                acc = contrib if acc is None else acc + contrib
                if t < S - 1:
                    acc = _lax.ppermute(acc, axis, perm)
            # device i now owns the reduced chunk (i+1) mod S; rebuild q
            # in column order (chunk j sits at device (j-1) mod S)
            gathered = _lax.all_gather(acc, axis, axis=0)   # (S, b, blk)
            q = jnp.concatenate([gathered[(j - 1) % S] for j in range(S)],
                                axis=1)
            return q[:, :n] if npad != n else q
    elif overlap_blocks > 1:
        blk = -(-n // overlap_blocks)

        def qprod(D):
            p = mm(D, B, trans_b=True)               # (b, m_local) local
            return jnp.concatenate(
                [psum(mm(p, _lax.slice_in_dim(B, j0, min(j0 + blk, n),
                                               axis=1)))
                 for j0 in range(0, n, blk)], axis=1)
    else:
        def qprod(D):
            """q = AᵀA D (psum'd over the row shards when sharded)."""
            return psum(mm(mm(D, B, trans_b=True), B))

    return jax.named_scope("slot_q_product")(qprod), bf16_q, A16


def default_bf16_q() -> bool:
    """``make_qprod``'s auto choice for the traced precision scope."""
    return (blas.current_precision() == _lax.Precision.DEFAULT
            and on_gpu())


def gram_slot_gather(G, idx, indices, n: int):
    """u1 (b,K) = G[idx, indices] (sentinel n → 0) and vtv (b,) =
    G[idx, idx] — the per-insert Gram-column slot extraction shared by
    both slot-space drivers.

    The fast path gathers each slot's aligned 128-element block from
    the fetched (b, n) row set through one flat take and extracts the
    element with a one-hot select-sum, in place of b·K point gathers.
    Exact: the one-hot sum adds exact zeros, so u1/vtv are
    bit-identical to the point-gather form. Falls back to
    take_along_axis when n is not a multiple of 128. The block gather
    and the row prefetch were chosen by measurements on the previous
    accelerator; on the GPU they await an A/B against the plain point
    gather (ROADMAP queue 1 #5)."""
    b = idx.shape[0]
    row = jnp.take(G, idx, axis=0)                   # (b, n) streaming
    safe = jnp.minimum(indices, n - 1)
    if n % 128 == 0:
        nb = n // 128
        blocks = row.reshape(b * nb, 128)
        gb = jnp.take(blocks,
                      jnp.arange(b)[:, None] * nb + safe // 128,
                      axis=0)                        # (b, K, 128)
        lane = jnp.arange(128)
        sel = (safe % 128)[:, :, None] == lane[None, None, :]
        u1 = jnp.where(indices < n, jnp.sum(gb * sel, axis=2),
                       jnp.array(0, row.dtype))
        vb = jnp.take(blocks, jnp.arange(b) * nb + idx // 128, axis=0)
        vtv = jnp.sum(vb * ((idx % 128)[:, None] == lane[None, :]),
                      axis=1)
    else:
        u1 = jnp.where(indices < n,
                       jnp.take_along_axis(row, safe, axis=1),
                       jnp.array(0, row.dtype))
        vtv = jnp.take_along_axis(row, idx[:, None], axis=1)[:, 0]
    return u1, vtv


def make_gram_u1(A, A16, bf16_q: bool, psum, dtype):
    """Shared gram-free insert-column factory: u1[j] = ⟨A e_ind_j,
    A e_idx⟩ over the live slots — two contiguous row gathers from a
    transposed copy and a b·K·m batched dot (the config-5 regime where
    the n² Gram cannot exist). On the one-pass bf16 route the gathers
    read the transposed bf16 copy: half the gather traffic, and the dot
    takes bf16 operands with float32 accumulation."""
    ATx = A16.T if bf16_q else A.T

    def gram_u1(idx, indices):
        V = jnp.take(ATx, idx, axis=0)           # (b, m)
        # sentinel slots (index n) gather zero rows -> u1 = 0 there,
        # matching the gram path's masked gather
        C = jnp.take(ATx, indices, axis=0, mode="fill",
                     fill_value=0)               # (b, K, m)
        u1 = jnp.einsum(
            "bkm,bm->bk", C, V,
            precision=(None if ATx.dtype == jnp.bfloat16
                       else blas.current_precision()),
            preferred_element_type=jnp.float32)
        return psum(u1).astype(dtype)

    return gram_u1


def _plan_tiers(k_max: int, max_iterations: int, ladder) -> list[int]:
    """Capacity ladder: after ``i`` iterations a lane holds at most
    ``i + 1`` support members (≤1 insert per iteration,
    homotopy-cpu.cpp:246), so the early path cannot use a full-capacity
    inverse buffer — every capacity-proportional cost (the insert's
    (b,K) Gram-column gather, the (b,K)-point direction scatter, the
    (b,K,K) transition) is paid for slots that are provably
    empty. Run iterations < K/2−1 in a half-capacity loop, then zero-pad
    the state into the full-capacity loop (one embed, exact: padded
    slots carry the sentinel index and zero rows, which the transition
    already treats as absent).

    ladder: None = auto (on for k_max ≥ 48; the threshold and the
    three-tier depth were measured on the previous accelerator and
    await an A/B on the GPU, ROADMAP queue 1 #5),
    True = force two tiers when structurally possible, False = off, or
    an explicit ascending tier list ending at k_max (infeasible
    intermediate tiers are dropped).
    """
    if ladder is False:
        return [k_max]
    if isinstance(ladder, (list, tuple)):
        assert list(ladder) == sorted(set(ladder)) and ladder[-1] == k_max, (
            f"ladder must be ascending and end at k_max={k_max}: {ladder}")
        return [K for K in ladder
                if K == k_max or (2 <= K and max_iterations > K)]
    half = lambda K: -(-((K + 1) // 2) // 8) * 8  # ceil(K/2), mult of 8
    if ladder is None and k_max < 48:
        return [k_max]
    # halve down to a 16-slot floor, at most 3 loops total (each tier is
    # a separately compiled while loop, so compile cost grows with it)
    tiers = [k_max]
    t = half(k_max)
    while t >= 16 and t < tiers[0] and len(tiers) < 3:
        if max_iterations > t:  # a tier no path can outgrow is skipped
            tiers.insert(0, t)
        t = half(t)
    if ladder is True and len(tiers) == 1:
        # forced: accept a sub-16 first tier if that is all that fits
        t = half(k_max)
        if 2 <= t < k_max and max_iterations > t:
            tiers.insert(0, t)
    return tiers


def synced_while(body, live_fn, st, sync_axes):
    """Driver while loop, optionally with a globally-uniform trip count.

    ``sync_axes=None``: the plain per-device loop (each device stops
    when its own lanes freeze — group-scoped all-reduces let groups
    progress independently). With axis names: every device carries a
    continue flag psum'd over ``sync_axes`` each iteration, so ALL
    devices execute identical trip counts — required whenever the body
    contains a collective WITHOUT subgroup scoping (``lax.ppermute``:
    its rendezvous spans every device in the pair list, so divergent
    counts across the data axis deadlock — measured on the virtual
    mesh, round 5). Frozen lanes pass through the extra iterations
    unchanged (the body's ``live`` masking), so results are identical
    to the unsynced loop."""
    if not sync_axes:
        return lax.while_loop(lambda s: jnp.any(live_fn(s)), body, st)

    def cont_of(s):
        return _lax.psum(jnp.any(live_fn(s)).astype(jnp.int32),
                         sync_axes) > 0

    def body2(c):
        s1 = body(c[0])
        return (s1, cont_of(s1))

    state, _ = lax.while_loop(lambda c: c[1], body2, (st, cont_of(st)))
    return state


def _embed(s: "_BState", K2: int, n: int) -> "_BState":
    """Zero-pad a capacity-K1 state into capacity K2 (> K1). Exact: the
    transition derives slot liveness from kk/indices, and the padded
    slots add exact zeros to every slot-axis reduction."""
    K1 = s.x_act.shape[1]
    p = K2 - K1
    pad2 = lambda a: jnp.pad(a, ((0, 0), (0, p)))
    return _BState(
        it=s.it, c=s.c, c_inf=s.c_inf, mask=s.mask,
        inv=jnp.pad(s.inv, ((0, 0), (0, p), (0, p))),
        gk=jnp.pad(s.gk, ((0, 0), (0, p), (0, p))),
        x_act=pad2(s.x_act), d_act=pad2(s.d_act), c_act=pad2(s.c_act),
        indices=jnp.pad(s.indices, ((0, 0), (0, p)), constant_values=n),
        kk=s.kk, broke=s.broke)


def solve_homotopy_batch(A: jnp.ndarray, G: jnp.ndarray | None,
                         Y: jnp.ndarray,
                         tolerance, max_iterations: int, k_max: int,
                         ladder: bool | None = None,
                         bf16_q: bool | None = None,
                         axis: str | None = None,
                         dense: bool = True,
                         record_path: bool = False,
                         overlap_blocks: int = 1,
                         overlap_mode: str = "psum",
                         axis_size: int | None = None,
                         sync_axes: tuple | None = None):
    """Fast-mode batched homotopy — the slot-space throughput driver.

    A: (m, n); G = AᵀA (n, n) or None; Y: (b, m). Returns (X (b, n),
    HomotopyReportArrays with per-lane arrays). ``ladder`` controls the capacity tiers (see _plan_tiers).

    ``G=None`` runs **gram-free**: the insert's K live Gram entries
    u1[j] = ⟨A e_ind_j, A e_idx⟩ are computed on the fly — two
    contiguous row gathers from a transposed copy plus a b·K·m batched
    dot (see gram_u1 below) — instead of an n×n table in device memory. This is
    the config-5 regime (n too large for n² bytes); everything else
    about the path is identical.

    ``axis`` runs the driver **row-sharded inside shard_map**: A is the
    local row shard (m_local, n), Y the matching (b_local, m_local)
    shard, and every product that reduces over rows (the init
    correlation Aᵀy, the q products, the gram-free diag/rows) ends in
    one ``lax.psum`` over ``axis`` — AᵀA = Σ_shards A_sᵀA_s, so partial
    per-shard products sum exactly. The (b, K) slot state, the γ scan
    and the transition are replicated across the row axis (they
    are identical deterministic functions of the psum'd q), which is the
    same replication contract as the sharded vmapped core
    (parallel/sharding.py).

    ``dense=False`` skips the final (b, n) scatter and returns the
    driver's own compact slot-space solution ``((values, indices),
    report)`` — values (b, k_max) at columns indices (b, k_max), with
    sentinel ``n`` marking empty slots. This is the CSR-style output the
    north star asks for (BASELINE.json): at config-5 scale
    (n = 131072, b = 128) the dense form is a 64 MiB device→host
    transfer for ~16 K actual nonzeros; the compact form moves
    2·b·k_max values. ``densify_batch`` reconstructs the dense X
    exactly.

    ``record_path=True`` additionally records the LARS/LASSO breakpoint
    history the loop already visits (see solvers/homotopy.py
    ``record_path``) and returns it as a third element
    ``(hist_v (b, T, k_max), hist_i (b, T, k_max), hist_l (b, T))``
    with T = max_iterations + 1 — the same compact slot-space form as
    the vmapped core's, lane-for-lane (tests/test_batch_native.py).
    The history carries live outside the driver's state so the
    ``record_path=False`` trace — the headline program — is unchanged.

    ``overlap_blocks`` > 1 (sharded only) splits each iteration's
    q = AᵀA d into that many independent column-block products, each
    ending in its own ``psum`` — block j's all-reduce overlaps with
    block j+1's local gemm (the north-star "overlap collective with
    next matvec tile", SURVEY.md §2.4). The per-element products are
    identical (each q element is still one dot over the local rows
    followed by the same psum tree), so the path is exact vs the
    unsplit driver.

    ``overlap_mode="ppermute"`` (sharded only; needs ``axis_size`` =
    the row-axis device count) replaces the psum with the hand-
    pipelined collective-matmul ring of ``make_qprod`` — S chained
    ``lax.ppermute`` steps interleaved with the local column-block
    gemms, which XLA's all-reduce combiner cannot re-merge (the psum
    block form's measured failure mode, docs/design.md §9). Summation
    order is ring-visit order — ulp-level fp differences from the psum
    tree, same class as the matmul precision ladder."""
    n = A.shape[1]
    T = max_iterations + 1
    if Y.shape[0] == 0:
        # empty batch: nothing to solve
        report = HomotopyReportArrays(
            iter=jnp.zeros((0,), jnp.uint32),
            solution_error=jnp.zeros((0,), A.dtype))
        out = (jnp.zeros((0, n), A.dtype) if dense else
               (jnp.zeros((0, k_max), A.dtype),
                jnp.full((0, k_max), n, jnp.int32)))
        if record_path:
            return out, report, (jnp.zeros((0, T, k_max), A.dtype),
                                 jnp.full((0, T, k_max), n, jnp.int32),
                                 jnp.zeros((0, T), A.dtype))
        return out, report
    tiers = _plan_tiers(k_max, max_iterations, ladder)
    b = Y.shape[0]
    bidx = jnp.arange(b)
    state = hist = None
    for t, Kt in enumerate(tiers):
        # non-final tiers stop before any lane could need slot Kt: with
        # it < Kt−1 every lane's support is ≤ it+1 ≤ Kt−1 < Kt, so the
        # overflow path can never trigger inside a non-final tier
        cap = None if t == len(tiers) - 1 else Kt - 1
        init, body, lane_live = make_stepper(
            A, G, Y, tolerance, max_iterations, Kt, it_cap=cap,
            bf16_q=bf16_q, axis=axis, overlap_blocks=overlap_blocks,
            overlap_mode=overlap_mode, axis_size=axis_size)
        st = init if state is None else _embed(state, Kt, n)
        if not record_path:
            state = synced_while(body, lane_live, st, sync_axes)
            continue
        # breakpoint history (slot space, like the core's): row 0 is the
        # λ-max end of the path (x = 0, λ0 = ‖Aᵀy‖∞); each live lane's
        # iteration writes its post-transition slot state at row it+1.
        # Frozen lanes are dropped by the sentinel row T (mode="drop"),
        # matching the vmapped core where batching masks their updates.
        if hist is None:
            hist = (jnp.zeros((b, T, Kt), A.dtype),
                    jnp.full((b, T, Kt), n, jnp.int32),
                    jnp.zeros((b, T), A.dtype).at[:, 0].set(st.c_inf))
        else:
            p = Kt - hist[0].shape[2]
            hist = (jnp.pad(hist[0], ((0, 0), (0, 0), (0, p))),
                    jnp.pad(hist[1], ((0, 0), (0, 0), (0, p)),
                            constant_values=n),
                    hist[2])

        def rec_body(carry, _body=body, _live=lane_live):
            s, (hv, hi, hl) = carry
            live = _live(s)
            s1 = _body(s)
            rows = jnp.where(live, s1.it, jnp.uint32(T)).astype(jnp.int32)
            hv = hv.at[bidx, rows].set(s1.x_act, mode="drop")
            hi = hi.at[bidx, rows].set(s1.indices, mode="drop")
            hl = hl.at[bidx, rows].set(s1.c_inf, mode="drop")
            return s1, (hv, hi, hl)

        state, hist = synced_while(
            rec_body, lambda c, _live=lane_live: _live(c[0]),
            (st, hist), sync_axes)
    final = state
    if dense:
        out = jnp.zeros((b, n), A.dtype).at[
            bidx[:, None], final.indices].set(final.x_act, mode="drop")
    else:
        out = (final.x_act, final.indices)
    report = HomotopyReportArrays(iter=final.it,
                                  solution_error=final.c_inf)
    if record_path:
        return out, report, hist
    return out, report


def densify_batch(values: jnp.ndarray, indices: jnp.ndarray, n: int):
    """Scatter a compact slot-space batch solution (``dense=False``)
    back to dense (b, n) — values (b, K) at columns indices (b, K),
    sentinel ``n`` = empty slot. Works on numpy or jax arrays."""
    values = jnp.asarray(values)
    indices = jnp.asarray(indices)
    b = values.shape[0]
    return jnp.zeros((b, n), values.dtype).at[
        jnp.arange(b)[:, None], indices].set(values, mode="drop")


def make_stepper(A, G, Y, tolerance, max_iterations: int, k_max: int,
                 it_cap: int | None = None,
                 bf16_q: bool | None = None, axis: str | None = None,
                 overlap_blocks: int = 1, overlap_mode: str = "psum",
                 axis_size: int | None = None):
    """Build (initial state, body, lane_live) for the batch driver —
    exposed so tests can step the iteration eagerly. ``it_cap`` freezes
    lanes at an iteration bound (the capacity-ladder phase boundary:
    such lanes resume unchanged in the next tier's loop). ``bf16_q``
    controls the one-pass bf16 q product (None = auto, make_qprod). ``G=None``
    = gram-free, ``axis`` = row-shard psum axis, ``overlap_blocks``
    splits the sharded q product into independently-psum'd column blocks
    (see solve_homotopy_batch)."""
    b, _ = Y.shape
    n = A.shape[1]
    K = k_max
    dtype = A.dtype
    if overlap_blocks > 1 and axis is None:
        raise ValueError(
            "overlap_blocks splits the sharded q psum into column-block "
            "collectives; without a shard axis there is no psum to "
            "overlap — pass axis=... or overlap_blocks=1")
    if dtype != jnp.float32:
        raise ValueError(
            "the batch-native driver is float32; "
            f"got {dtype} — use the vmapped core (api routes f64 there)")
    tol = jnp.asarray(tolerance, dtype)
    bidx = jnp.arange(b)
    psum = (lambda v: _lax.psum(v, axis)) if axis is not None else (
        lambda v: v)
    gdiag = jnp.diagonal(G) if G is not None else psum(
        jnp.sum(A * A, axis=0))

    # q product: on the one-pass route two bf16 gemms on a bf16 copy of
    # A (ops/slot.normal_matvec_bf16), else the float32 two-gemm form at
    # the traced precision. See make_qprod for the overlapped sharded
    # forms.
    qprod, bf16_q, A16 = make_qprod(A, psum, overlap_blocks, bf16_q, n,
                                     overlap_mode=overlap_mode,
                                     axis=axis, axis_size=axis_size)

    # Gram-free insert column: the transition consumes ONLY the K live
    # entries u1[j] = (AᵀA)[ind_j, idx] = ⟨A e_ind_j, A e_idx⟩ (plus the
    # diagonal, read from the exact gdiag). Materializing the full
    # (b, n) Gram row Aᵀ(A e_idx) would pay a b·m·n gemm per iteration;
    # the direct form is two contiguous row gathers from a transposed
    # copy — (b, m) for the inserted column, (b, K, m) for the active
    # columns — and a b·K·m batched dot: n/K times fewer MACs. Same
    # products, same f32 accumulation of the same inputs; only the
    # summation order differs.
    if G is None:
        gram_u1 = make_gram_u1(A, A16, bf16_q, psum, dtype)

    # --- init (solve_homotopy_core init, batched; homotopy-cpu.cpp:215-229)
    C0 = psum(blas.xgemm(Y, A))                 # c0 = Aᵀy per lane
    idx0 = jnp.argmax(jnp.abs(C0), axis=1).astype(jnp.int32)
    c_inf0 = jnp.abs(_take1(C0, idx0))
    vtv0 = jnp.take(gdiag, idx0)
    # initial direction: sign of ‖c‖∞ (+1), NOT sign(c[idx0]) — the
    # reference quirk; the slot's *tracked* sign is sign(c[idx0]), the
    # value every later direction update uses.
    ds0 = _sign_deadzone(c_inf0, tol) / vtv0
    init = _BState(
        it=jnp.zeros(b, jnp.uint32),
        c=C0,
        c_inf=c_inf0,
        mask=jnp.zeros((b, n), jnp.int8).at[bidx, idx0].set(1),
        inv=jnp.zeros((b, K, K), dtype).at[bidx, 0, 0].set(1 / vtv0),
        gk=jnp.zeros((b, K, K), dtype).at[bidx, 0, 0].set(vtv0),
        x_act=jnp.zeros((b, K), dtype),
        d_act=jnp.zeros((b, K), dtype).at[:, 0].set(ds0),
        c_act=jnp.zeros((b, K), dtype).at[:, 0].set(_take1(C0, idx0)),
        indices=jnp.full((b, K), n, jnp.int32).at[:, 0].set(idx0),
        kk=jnp.ones(b, jnp.int32),
        broke=jnp.zeros(b, bool),
    )

    def lane_live(s: _BState):
        # per-lane do-while (homotopy-cpu.cpp:236)
        live = (s.it == 0) | (
            (~s.broke) & (s.it < jnp.uint32(max_iterations))
            & (s.c_inf > tol))
        if it_cap is not None:
            live = live & (s.it < jnp.uint32(it_cap))
        return live

    def body(s: _BState) -> _BState:
        live = lane_live(s)

        # q = AᵀA d: scatter the slot direction, then two gemms (bf16 on
        # the one-pass route; psum'd per row shard)
        D = jnp.zeros((b, n), dtype).at[bidx[:, None], s.indices].set(
            s.d_act, mode="drop")
        q = qprod(D)

        gamma_raw, idx = _slot.find_max_gamma(
            q, s.c, s.mask, s.c_inf, s.x_act, s.d_act, s.indices)

        # membership from the slot indices, not the mask: a (b,K) compare
        # instead of a (b,n) read (the mask's only readers are the scan
        # and its point update)
        present = jnp.any(s.indices == idx[:, None], axis=1)
        empty = present & (s.kk == 1)
        if k_max <= max_iterations:
            # a user-shrunk capacity can overflow; break instead of
            # writing out of bounds (cannot happen at the default
            # k_max = max_iterations + 1: ≤1 insert per iteration)
            empty = empty | (~present & (s.kk >= k_max))
        gamma = jnp.where(live & ~empty, gamma_raw, jnp.array(0, dtype))

        # insert's Gram column over the live slots (online_inverse.h:
        # 217-218): one contiguous row of G + one (b,K) point gather.
        # Gram-free: u1 computed directly over the live slots (see
        # gram_u1 above; at config-5 scale the n² table cannot exist),
        # with vtv = ‖A e_idx‖² from the exact f32 gdiag (it feeds the
        # insert's degeneracy guard)
        if G is not None:
            # vtv reads from the fetched row set too; block-extraction
            # rationale in gram_slot_gather
            u1, vtv = gram_slot_gather(G, idx, s.indices, n)
        else:
            u1 = gram_u1(idx, s.indices)
            vtv = jnp.take(gdiag, idx)
        # c′ at the toggled coordinate — the inserted slot's correlation
        cnew = _take1(s.c, idx) - gamma * _take1(q, idx)

        doins = live & ~present & (s.kk < K)
        # `~empty` gates the remove: when the scan selects removal of the
        # only active member (kk == 1) the lane breaks with its solution
        # intact (the core/reference break BEFORE touching the support,
        # homotopy-cpu.cpp:246 K==0 break) — without the gate the
        # transition would vswap x_act to zero and the final slot-scatter
        # would return X = 0 for the lane
        dorm = live & present & ~empty
        # `deg` flags inserts whose Schur complement was rounding noise
        # (support at rank deficiency): the transition leaves the lane's
        # state untouched and the lane breaks below, like a capacity
        # overflow — solution intact, honest error > tol
        inv1, gk1, x_act1, d_act1, c_act1, ind1, deg = _slot.transition(
            s.inv, s.gk, s.x_act, s.d_act, s.c_act, s.indices, u1, idx,
            s.kk, gamma, vtv, cnew, live, doins, dorm, tol, n)

        stepped = live & ~empty & ~deg
        c1 = jnp.where(stepped[:, None], s.c - gamma[:, None] * q, s.c)
        c_inf1 = jnp.where(stepped, jnp.max(jnp.abs(c1), axis=1), s.c_inf)
        mval = jnp.where(dorm, jnp.int8(0),
                         jnp.where(doins & ~deg, jnp.int8(1),
                                   present.astype(jnp.int8)))
        mask1 = s.mask.at[bidx, idx].set(mval)
        kk1 = jnp.where(dorm, s.kk - 1,
                        jnp.where(doins & ~deg, s.kk + 1, s.kk))

        # per-lane finiteness break: the reference's arithmetic on
        # rank-deficient supports can overflow through a huge 1/den
        # (negative/noise-level dens are allowed through deliberately —
        # see ops/slot._bordered_insert); a lane whose slot state
        # went non-finite stops here with its committed (finite) x and c
        # rather than poisoning later iterations
        blew = live & ~(jnp.isfinite(x_act1).all(axis=1)
                        & jnp.isfinite(d_act1).all(axis=1)
                        & jnp.isfinite(c_act1).all(axis=1)
                        & jnp.isfinite(inv1[:, 0, 0]))

        return _BState(
            it=s.it + live.astype(jnp.uint32),
            c=c1, c_inf=c_inf1, mask=mask1,
            inv=inv1, gk=gk1, x_act=x_act1, d_act=d_act1, c_act=c_act1,
            indices=ind1, kk=kk1,
            broke=s.broke | (live & (empty | deg)) | blew,
        )

    return init, body, lane_live
