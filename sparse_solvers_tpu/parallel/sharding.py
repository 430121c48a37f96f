"""Multi-device sharded solves — row-partitioned sensing matrix over a mesh.

The reference is single-process/single-thread (SURVEY.md §2.4); the scaling
design it maps to on an accelerator mesh is: shard A's rows (the m axis)
across devices, so each device computes partial correlations
Aᵀ_shard·r_shard, combined with a single ``psum`` per product; the small active-set state (the γ scan,
the K_max² Gram inverse) is replicated. Batches of signals shard over a
second ``data`` mesh axis. Everything is expressed with ``shard_map`` over a
``jax.sharding.Mesh`` + the RowShardedOperator (ops/operators.py), letting
XLA schedule the collectives (scaling-book recipe: pick a mesh, annotate,
let XLA insert collectives).

Mesh axes:
  * "row"  — partitions A's rows / the signal's m dimension (tensor axis)
  * "data" — partitions the signal batch (data-parallel axis)
"""

from __future__ import annotations

import functools
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import blas
from ..ops.operators import RowShardedOperator
from ..solvers.homotopy import solve_homotopy_core
from ..solvers.irls import solve_irls_core

ROW_AXIS = "row"
DATA_AXIS = "data"


def make_mesh(n_row: int | None = None, n_data: int = 1,
              devices=None) -> Mesh:
    """Build a (data, row) mesh. Defaults to all rows on all devices."""
    devices = devices if devices is not None else jax.devices()
    if n_row is None:
        n_row = len(devices) // n_data
    dev = np.asarray(devices[: n_data * n_row]).reshape(n_data, n_row)
    return Mesh(dev, (DATA_AXIS, ROW_AXIS))


def _pad_rows(A, mesh):
    """Pad A/y rows to a multiple of the row-axis size. Zero rows change
    neither Aᵀ(y−Ax) nor AᵀA, so solver results are unaffected."""
    n_row = mesh.shape[ROW_AXIS]
    m = A.shape[0]
    pad = (-m) % n_row
    if pad:
        A = jnp.pad(A, ((0, pad), (0, 0)))
    return A, pad


def _pad_vec(y, pad):
    return jnp.pad(y, ((0, pad),)) if pad else y


# Replicated Gram matrices above this size are not built automatically in
# the sharded solver (n² bytes *per device*).
_SHARDED_GRAM_AUTO_BYTES = 1 << 30


def _cert_failures(errs, iters, tolerance, max_iterations: int):
    """Certified-mode failure mask: lanes whose high-precision
    certificate missed the tolerance without exhausting max_iterations
    (a non-finite certificate counts as failing). Module-level so tests
    can monkeypatch it to force the re-solve/merge branch."""
    return (~(np.asarray(errs) <= float(tolerance))
            & (np.asarray(iters) < max_iterations))


@functools.lru_cache(maxsize=128)
def _homotopy_sharded_fn(mesh: Mesh, path_precision: str, gram: bool,
                         batch_native: bool, overlap_split: int,
                         max_iterations: int, k_max: int, certified: bool,
                         dense: bool = True, overlap_blocks: int = 1,
                         overlap_mode: str = "psum",
                         gram_in: bool = False):
    """Build (and cache) the jitted shard_map'd homotopy solve for one
    static configuration. Caching at module level makes repeated *eager*
    ``homotopy_sharded`` calls amortized like the construct-once
    unsharded API — without it every serving call re-traced the
    shard_map. ``tolerance`` is a traced argument (no recompiles across
    tolerances); jit itself re-specializes per input shape."""
    out_spec = (P(DATA_AXIS, None) if dense
                else (P(DATA_AXIS, None), P(DATA_AXIS, None)))

    g_spec = (P(None, None),) if gram_in else ()

    @partial(shard_map, mesh=mesh,
             in_specs=(P(ROW_AXIS, None),) + g_spec
                      + (P(DATA_AXIS, ROW_AXIS), P()),
             out_specs=(out_spec,
                        (P(DATA_AXIS), P(DATA_AXIS))),
             check_vma=False)
    def run(A_local, *rest):
        if gram_in:
            G_in, Y_local, tol = rest
        else:
            G_in = None
            Y_local, tol = rest
        n = A_local.shape[1]  # row shards keep every column (global n)
        m_global = A_local.shape[0] * mesh.shape[ROW_AXIS]
        # a precomputed replicated Gram (the mesh facade's construct-
        # once amortization) skips the per-call psum'd build, which runs
        # at HIGHEST like every other Gram (gram_replicated, the
        # unsharded façades): the path precision is TF32 on the GPU
        G = G_in if gram_in else (_gram_psum(A_local) if gram else None)
        with blas.precision_scope(path_precision):
            if batch_native:
                from ..solvers.homotopy_batch import solve_homotopy_batch
                X, rep = solve_homotopy_batch(
                    A_local, G, Y_local, tol, max_iterations, k_max,
                    axis=ROW_AXIS, dense=dense,
                    overlap_blocks=overlap_blocks,
                    overlap_mode=overlap_mode,
                    axis_size=mesh.shape[ROW_AXIS],
                    # ppermute's rendezvous is unscoped: divergent
                    # while counts across the data axis deadlock, so
                    # the loop carries a globally-psum'd continue flag
                    # (homotopy_batch.synced_while)
                    sync_axes=((DATA_AXIS, ROW_AXIS)
                               if (overlap_mode == "ppermute"
                                   and mesh.shape[DATA_AXIS] > 1)
                               else None))
            else:
                op = RowShardedOperator(A_local, ROW_AXIS, G,
                                        split=overlap_split)
                # With a replicated Gram and few lanes per device, the
                # γ-scan product q = AᵀAd comes from Gram-column gathers —
                # zero collectives per iteration (SURVEY.md §2.4 north
                # star); the dense two-step (one psum) wins once the
                # local batch is large.
                local_batch = Y_local.shape[0]
                sparse = gram and local_batch * k_max < 2 * m_global
                solve = lambda y_local: solve_homotopy_core(
                    op, n, y_local, tol, max_iterations, k_max,
                    sparse_matvec=sparse, compact=not dense)
                X, rep = jax.vmap(solve, in_axes=(0,))(Y_local)
        err = rep.solution_error
        if certified:
            # sharded certificate: per-shard partial correlations of the
            # returned solutions, one psum over the row axis, at
            # blas.PARITY (the solver's own convergence criterion).
            # Compact output densifies locally for the certificate only
            # (the saving of dense=False is the host transfer).
            from ..solvers.homotopy_batch import densify_batch
            Xd = X if dense else densify_batch(X[0], X[1], n)
            with blas.precision_scope(blas.PARITY):
                r_loc = Y_local - blas.xgemm(Xd, A_local, trans_b=True)
                c_part = blas.xgemm(r_loc, A_local)
            c = jax.lax.psum(c_part, ROW_AXIS)
            err = jnp.max(jnp.abs(c), axis=-1).astype(err.dtype)
        return X, (rep.iter, err)

    return jax.jit(run)


def homotopy_sharded(mesh: Mesh, A: jnp.ndarray, Y: jnp.ndarray, tolerance,
                     max_iterations: int, k_max: int | None = None,
                     gram: bool | None = None, overlap_split: int = 1,
                     precision: str = "high",
                     batch_native: bool | None = None,
                     dense: bool = True,
                     overlap_blocks: int | None = None,
                     overlap_mode: str | None = None,
                     G: jnp.ndarray | None = None):
    """Row-sharded, batch-sharded homotopy solve.

    A: (m, n) — rows sharded over the "row" axis, replicated over "data".
    Y: (batch, m) — batch over "data", m over "row".
    Returns (X: (batch, n) sharded over "data", reports pytree).
    ``dense=False`` returns ``(values, indices, reports)`` — the compact
    slot-space solution, shapes (batch, k_max) with sentinel index n
    (see ``Homotopy.solve_batch``); the (batch, n) scatter and its
    device→host transfer are skipped.

    ``overlap_blocks`` (batch-native driver only; default auto: 4 when
    the row axis is actually sharded and n ≥ 512, else 1) splits each
    iteration's q = AᵀA d into that many independent column-block
    products, each ending in its own psum, so XLA's async collectives
    overlap block j's all-reduce with block j+1's local gemm — the
    "overlap collective with next matvec tile" design applied to
    the throughput driver (the vmapped core's analog is
    ``overlap_split``). Exact: identical per-element products and psum
    trees (tests pin both the HLO collective structure and exactness
    vs the unsplit driver). Pass 1 to disable.

    ``precision`` follows the api's settings ("highest"/"high"/
    "default"/"certified"). Under "certified" the path runs at one-pass
    precision and each lane's final ‖Aᵀ(y−Ax)‖∞ is recomputed at
    ``blas.PARITY`` *inside the shard_map* — per-shard partial
    correlations combined by one psum over the row axis — and reported
    as solution_error; lanes whose certificate misses the tolerance
    without exhausting max_iterations trigger one full re-solve at
    ``blas.PARITY`` (merged per lane), mirroring ``Homotopy.solve_batch``.
    Like ``solve_batch``, the certified re-solve is a host-side,
    data-dependent decision and cannot live under an outer ``jax.jit``
    — call eagerly (the solve itself is already jitted through
    ``shard_map``), or use precision="high"/"default" under jit and
    check ``solution_error <= tolerance`` downstream (a clear
    ValueError replaces the tracer leak otherwise).

    ``gram`` (default auto, on while n² fits in 1 GiB/device) builds the
    replicated Gram AᵀA once per call — one psum'd gemm — after which
    every active-set insert is a local row lookup instead of a
    psum-per-insert Gram-column product (SURVEY.md §2.4: minimize
    collectives per iteration). ``gram=False`` is the config-5 regime
    (n too large to replicate n²): Gram columns are psum'd per insert.

    ``overlap_split`` > 1 splits each correlation psum into that many
    independent column-block psums so XLA can overlap each collective
    with the next block's local gemv (benchmarks/bench_scaling.py
    records the experiment).

    ``overlap_mode`` (batch-native driver only): "ppermute" replaces
    the driver's q psum with the hand-pipelined collective-matmul ring
    (solvers/homotopy_batch.make_qprod) — S = row-axis chained
    ``lax.ppermute`` steps interleaved with the local column-block
    gemms, which XLA's all-reduce combiner cannot re-merge (the
    measured failure mode of the psum block form, docs/design.md §9) —
    so the transfer can run behind the gemms. "auto" (default) picks it whenever the row axis is
    sharded and ring chunks stay lane-aligned (n ≥ 128·S) unless an
    explicit ``overlap_blocks`` keeps the psum form; "psum" keeps the
    round-4 column-block psums. Ring summation order differs from the
    psum tree by f32 ulps (the precision-ladder class of difference;
    certified precision covers it).

    ``batch_native`` (default auto: the shared rule
    homotopy_batch.route_batch_native, as in ``Homotopy.solve_batch``;
    SS_BATCH_NATIVE=1/0 forces/forbids) runs the slot-space throughput
    driver *inside* the shard_map — lane-local scan/transition
    replicated over the row axis, the
    q products psum'd per row shard (solvers/homotopy_batch.py). With
    ``gram=False`` the driver runs gram-free (on-the-fly Gram rows, the
    config-5 large-n regime). Off, the vmapped while_loop core carries
    the solve (the only option for f64).
    """
    from ..api import _check_max_iterations
    _check_max_iterations(max_iterations)
    if precision not in ("highest", "high", "default", "certified"):
        raise ValueError(
            "precision must be 'highest', 'high', 'default' or "
            f"'certified', got {precision!r}")
    certified = precision == "certified"
    path_precision = "default" if certified else precision
    n = A.shape[1]
    k_max = k_max or min(n, max_iterations + 1)
    if G is not None:
        if gram is False:
            raise ValueError("a precomputed G was passed with gram=False")
        gram = True
    if gram is None:
        gram = n * n * A.dtype.itemsize <= _SHARDED_GRAM_AUTO_BYTES
    if batch_native and overlap_split > 1:
        raise ValueError(
            "overlap_split > 1 splits the vmapped core's correlation "
            "psums; the batch-native driver has no per-correlation psum "
            "to split — use one or the other")
    if batch_native is None:
        if overlap_split > 1:
            # the overlap experiment is a vmapped-core construct — the
            # driver would silently drop it (review finding)
            batch_native = False
        else:
            # the rule shared with Homotopy._plan (homotopy_batch.
            # route_batch_native), with the `sparse` heuristic on the
            # per-device lane count: the zero-collective Gram-gather
            # vmapped core keeps small local batches
            from ..solvers.homotopy_batch import route_batch_native
            local_batch = -(-Y.shape[0] // mesh.shape[DATA_AXIS])
            sparse = (gram and local_batch * k_max < 2 * A.shape[0]
                      and k_max < n)
            batch_native = route_batch_native(local_batch, A.dtype,
                                              sparse)
    S = mesh.shape[ROW_AXIS]
    if overlap_mode not in (None, "auto", "psum", "ppermute"):
        raise ValueError(
            "overlap_mode must be 'auto', 'psum' or 'ppermute', got "
            f"{overlap_mode!r}")
    if overlap_mode in (None, "auto"):
        # auto: the hand-pipelined ppermute ring whenever there is a
        # reduction to hide and the ring chunks stay lane-aligned
        # (n/S ≥ 128). The ring was made the default on the previous
        # accelerator, where it was the only form whose overlap survived
        # XLA's all-reduce combiner (docs/design.md §9). On four H100
        # 80GB HBM3 cards (700 W) at 4096×8192, k=64, b=256 it took
        # 28.0 ms per batch against psum's 24.3 ms; the default awaits
        # a traced A/B (ROADMAP queue 1 #6). An explicit overlap_blocks
        # (even 1 = "plain psum") opts out.
        overlap_mode = ("ppermute"
                        if (batch_native and S > 1 and n >= 128 * S
                            and overlap_blocks is None)
                        else "psum")
    if overlap_mode == "ppermute":
        if not batch_native or S < 2:
            raise ValueError(
                "overlap_mode='ppermute' ring-pipelines the batch-native "
                "driver's q reduction over the row shards; it needs "
                "batch_native=True and a row axis of size >= 2")
        if overlap_blocks not in (None, 1):
            raise ValueError(
                "overlap_blocks is the psum-mode knob; the ppermute ring "
                "always uses S = row-axis chunks")
        overlap_blocks = 1
    elif overlap_blocks is None:
        # psum-mode auto: offer the column-block overlap when there is a
        # psum to hide and enough columns for ≥128-lane blocks (XLA's
        # combiner currently declines the offer — see overlap_mode)
        overlap_blocks = (4 if (batch_native and S > 1 and n >= 512)
                          else 1)
    if overlap_blocks > 1 and not batch_native:
        raise ValueError(
            "overlap_blocks splits the batch-native driver's q psum; "
            "the vmapped core's analog is overlap_split")
    A, pad = _pad_rows(A, mesh)
    Y = jnp.pad(Y, ((0, 0), (0, pad))) if pad else Y

    fn = _homotopy_sharded_fn(mesh, path_precision, bool(gram),
                              bool(batch_native), overlap_split,
                              max_iterations, k_max, certified,
                              dense=dense, overlap_blocks=overlap_blocks,
                              overlap_mode=overlap_mode,
                              gram_in=G is not None)
    args = (A,) + (() if G is None else (G,)) + (
        Y, jnp.asarray(tolerance, A.dtype))
    X, (iters, errs) = fn(*args)
    from ..solvers.homotopy import HomotopyReportArrays
    rep = HomotopyReportArrays(iter=iters, solution_error=errs)
    if certified:
        import numpy as np
        if isinstance(errs, jax.core.Tracer):
            raise ValueError(
                "homotopy_sharded(precision='certified') was called under "
                "an outer jit trace: the certified re-solve is a host-side "
                "decision on the per-lane certificates and cannot be "
                "staged. Call it eagerly (the solve is already compiled "
                "through shard_map), or use precision='high' under jit "
                "and check solution_error <= tolerance downstream")
        bad = _cert_failures(errs, iters, tolerance, max_iterations)
        if bad.any():
            out_h = homotopy_sharded(
                mesh, A[:A.shape[0] - pad] if pad else A,
                Y[:, :Y.shape[1] - pad] if pad else Y,
                tolerance, max_iterations, k_max=k_max, gram=gram,
                overlap_split=overlap_split, precision=blas.PARITY,
                batch_native=batch_native, dense=dense,
                overlap_blocks=overlap_blocks, overlap_mode=overlap_mode,
                G=G)
            rh = out_h[-1]
            sel = jnp.asarray(bad)
            if dense:
                X = jnp.where(sel[:, None], out_h[0], X)
            else:
                X = (jnp.where(sel[:, None], out_h[0], X[0]),
                     jnp.where(sel[:, None], out_h[1], X[1]))
            rep = HomotopyReportArrays(
                iter=jnp.where(sel, rh.iter, rep.iter),
                solution_error=jnp.where(sel, rh.solution_error,
                                         rep.solution_error))
    if not dense:
        return X[0], X[1], rep
    return X, rep


@functools.lru_cache(maxsize=128)
def _omp_sharded_fn(mesh: Mesh, precision: str, gram: bool,
                    max_iterations: int, k_max: int, corr: str,
                    batch_native: bool = False, dense: bool = True,
                    overlap_blocks: int = 1, certified: bool = False,
                    overlap_mode: str = "psum", gram_in: bool = False,
                    picks: int = 1):
    # (picks reaches both the vmapped core and the batch driver)
    from ..solvers.omp import solve_omp_core

    out_spec = (P(DATA_AXIS, None) if dense
                else (P(DATA_AXIS, None), P(DATA_AXIS, None)))
    g_spec = (P(None, None),) if gram_in else ()

    @partial(shard_map, mesh=mesh,
             in_specs=(P(ROW_AXIS, None),) + g_spec
                      + (P(DATA_AXIS, ROW_AXIS), P()),
             out_specs=(out_spec, (P(DATA_AXIS), P(DATA_AXIS))),
             check_vma=False)
    def run(A_local, *rest):
        if gram_in:
            G_in, Y_local, tol = rest
        else:
            G_in = None
            Y_local, tol = rest
        n = A_local.shape[1]
        G = G_in if gram_in else (_gram_psum(A_local) if gram else None)
        with blas.precision_scope(precision):
            if batch_native:
                from ..solvers.omp_batch import solve_omp_batch
                X, rep = solve_omp_batch(
                    A_local, G, Y_local, tol, max_iterations, k_max,
                    axis=ROW_AXIS, dense=dense,
                    overlap_blocks=overlap_blocks,
                    overlap_mode=overlap_mode,
                    axis_size=mesh.shape[ROW_AXIS],
                    sync_axes=((DATA_AXIS, ROW_AXIS)
                               if (overlap_mode == "ppermute"
                                   and mesh.shape[DATA_AXIS] > 1)
                               else None),
                    picks=picks)
                # the driver's reported error IS the psum'd
                # high-precision certificate (solvers/omp_batch.py)
                return X, (rep.iter, rep.solution_error)
            op = RowShardedOperator(A_local, ROW_AXIS, G)
            solve = lambda y_local: solve_omp_core(
                op, n, y_local, tol, max_iterations, k_max, corr=corr,
                picks=picks)
            X, rep = jax.vmap(solve, in_axes=(0,))(Y_local)
            err = rep.solution_error
            if certified:
                # sharded ℓ₂ certificate at blas.PARITY: per-shard partial
                # residual norms, one psum over the row axis (the
                # homotopy_sharded certificate pattern on the greedy
                # criterion)
                with blas.precision_scope(blas.PARITY):
                    R_loc = Y_local - blas.xgemm(X, A_local, trans_b=True)
                    err = jnp.sqrt(jnp.maximum(jax.lax.psum(
                        jnp.sum(R_loc * R_loc, axis=1), ROW_AXIS), 0)
                    ).astype(err.dtype)
            if not dense:
                from ..api import _compact_from_dense_jax
                X = _compact_from_dense_jax(X, k_max)
        return X, (rep.iter, err)

    return jax.jit(run)


def omp_sharded(mesh: Mesh, A: jnp.ndarray, Y: jnp.ndarray, tolerance,
                max_iterations: int, k_max: int | None = None,
                gram: bool | None = None, precision: str = "highest",
                batch_native: bool | None = None, dense: bool = True,
                overlap_blocks: int | None = None,
                overlap_mode: str | None = None,
                G: jnp.ndarray | None = None, picks: int = 1):
    """Row-sharded, batch-sharded OMP (solvers/omp.py — the greedy
    beyond-reference family) over the same (data, row) mesh layout as
    ``homotopy_sharded``: per-iteration residual correlations psum once
    over the row axis (or gather from a replicated Gram with zero
    per-iteration collectives), the k_max² online inverse and the LS
    coefficients replicated; ‖r‖² reductions psum with the same
    collective. Returns (X: (batch, n) data-sharded, OmpReportArrays).

    ``batch_native`` (default auto: the homotopy driver's routing rule
    on the per-device lane count, f32 required;
    SS_BATCH_NATIVE=1/0 forces/forbids) runs the slot-space OMP batch
    driver (solvers/omp_batch.py — q product + in-place insert/LS)
    *inside* the shard_map, its q products psum'd per row
    shard and its reported error the psum'd high-precision residual
    certificate. With ``gram=False`` the driver runs gram-free
    (on-the-fly insert columns, one extra psum per pick — the config-5
    large-n regime). Off, the vmapped pick loop carries the solve.

    ``dense=False`` returns ``(values, indices, reports)`` — the
    compact slot-space solution, shapes (batch, k_max), sentinel index
    n (see ``Omp.solve_batch``); the (batch, n) scatter's device→host
    transfer is skipped.

    ``overlap_blocks`` (driver only; default auto: 4 when the row axis
    is actually sharded and n ≥ 512, else 1) splits each pick's
    q = AᵀA D psum into that many column-block collectives so each
    all-reduce overlaps the next block's local gemm — the same
    north-star overlap as ``homotopy_sharded``. Exact vs the unsplit
    driver. ``overlap_mode`` ("auto" default) upgrades the sharded
    driver to the ppermute collective-matmul ring exactly as in
    ``homotopy_sharded`` (ulp-level ring-order fp differences).

    ``precision="certified"`` mirrors ``homotopy_sharded``: the pick
    loop runs at one-pass precision, each lane's reported error is the
    psum'd parity-grade ℓ₂ residual certificate (the driver computes
    it unconditionally; the vmapped loop gets a per-shard partial-norm
    psum), and lanes whose certificate misses the tolerance without
    exhausting max_iterations re-solve once at blas.PARITY — a host-side
    decision, so certified cannot run under an outer jit (a clear
    ValueError replaces the tracer leak).
    """
    from ..api import _check_max_iterations
    _check_max_iterations(max_iterations)
    if precision not in ("highest", "high", "default", "certified"):
        raise ValueError(
            "precision must be 'highest', 'high', 'default' or "
            f"'certified', got {precision!r}")
    certified = precision == "certified"
    path_precision = "default" if certified else precision
    m, n = A.shape
    # global-m capacity (the core would see only the local shard)
    k_max = k_max or max(1, min(max_iterations, m, n))
    gram_arg = gram  # the user's argument — the certified re-solve
    # recursion must pass THIS through, not the auto-resolved bool (an
    # auto-True handed back as gram=True would become gram_forced and
    # pin corr='gram' past the crossover — review finding)
    gram_forced = gram is True
    if G is not None:
        if gram is False:
            raise ValueError("a precomputed G was passed with gram=False")
        gram = True
    if gram is None:
        gram = n * n * A.dtype.itemsize <= _SHARDED_GRAM_AUTO_BYTES
    if picks < 1:
        raise ValueError(f"picks must be >= 1, got {picks}")
    local_batch = -(-Y.shape[0] // mesh.shape[DATA_AXIS])
    if batch_native is None:
        # gram=False runs the driver gram-free (on-the-fly insert
        # columns — the config-5 large-n regime, like homotopy's); the
        # sparse leg keeps the gather-based vmapped core below the
        # batch·k_max < 2m crossover, and gram=True pins the
        # Gram-gather vmapped formulation outright (api.Omp contract)
        from ..solvers.homotopy_batch import route_batch_native
        batch_native = (not gram_forced) and route_batch_native(
            local_batch, A.dtype,
            sparse=local_batch * k_max < 2 * m)
    S = mesh.shape[ROW_AXIS]
    if overlap_mode not in (None, "auto", "psum", "ppermute"):
        raise ValueError(
            "overlap_mode must be 'auto', 'psum' or 'ppermute', got "
            f"{overlap_mode!r}")
    if overlap_mode in (None, "auto"):
        # homotopy_sharded's auto rule: the ppermute ring is the only
        # overlap the current toolchain actually schedules
        overlap_mode = ("ppermute"
                        if (batch_native and S > 1 and n >= 128 * S
                            and overlap_blocks is None)
                        else "psum")
    if overlap_mode == "ppermute":
        if not batch_native or S < 2:
            raise ValueError(
                "overlap_mode='ppermute' ring-pipelines the batch-native "
                "driver's q reduction over the row shards; it needs "
                "batch_native=True and a row axis of size >= 2")
        if overlap_blocks not in (None, 1):
            raise ValueError(
                "overlap_blocks is the psum-mode knob; the ppermute ring "
                "always uses S = row-axis chunks")
        overlap_blocks = 1
    elif overlap_blocks is None:
        overlap_blocks = (4 if (batch_native and S > 1 and n >= 512)
                          else 1)
    if overlap_blocks > 1 and not batch_native:
        raise ValueError(
            "overlap_blocks splits the batch-native driver's q psum; "
            "the vmapped pick loop has no per-block product to split")
    # correlation-formulation routing on the per-device lane count (the
    # api.Omp._route_corr rule; "sparse" gathers a (lanes·k, m_local)
    # tensor per iteration — past the crossover the dense local gemms
    # avoid it). gram=True pins the zero-per-iteration-
    # collective Gram form (auto-gram still serves the O(k) inserts on
    # the dense route); the dense form pays one rmatvec psum per pick.
    small = local_batch * k_max < 2 * m
    if gram_forced or (gram and small):
        corr = "gram"
    else:
        corr = "sparse" if small else "dense"
    A, pad = _pad_rows(A, mesh)
    Y = jnp.pad(Y, ((0, 0), (0, pad))) if pad else Y
    fn = _omp_sharded_fn(mesh, path_precision, bool(gram), max_iterations,
                         k_max, corr, batch_native=bool(batch_native),
                         dense=dense, overlap_blocks=overlap_blocks,
                         certified=certified, overlap_mode=overlap_mode,
                         gram_in=G is not None, picks=picks)
    args = (A,) + (() if G is None else (G,)) + (
        Y, jnp.asarray(tolerance, A.dtype))
    X, (iters, errs) = fn(*args)
    from ..solvers.omp import OmpReportArrays
    rep = OmpReportArrays(iter=iters, solution_error=errs)
    if certified:
        import numpy as np
        if isinstance(errs, jax.core.Tracer):
            raise ValueError(
                "omp_sharded(precision='certified') was called under an "
                "outer jit trace: the certified re-solve is a host-side "
                "decision on the per-lane certificates and cannot be "
                "staged. Call it eagerly (the solve is already compiled "
                "through shard_map), or use precision='high' under jit "
                "and check solution_error <= tolerance downstream")
        bad = _cert_failures(errs, iters, tolerance, max_iterations)
        if bad.any():
            out_h = omp_sharded(
                mesh, A[:A.shape[0] - pad] if pad else A,
                Y[:, :Y.shape[1] - pad] if pad else Y,
                tolerance, max_iterations, k_max=k_max, gram=gram_arg,
                precision=blas.PARITY, batch_native=batch_native,
                dense=dense, overlap_blocks=overlap_blocks,
                overlap_mode=overlap_mode, G=G, picks=picks)
            rh = out_h[-1]
            sel = jnp.asarray(bad)
            if dense:
                X = jnp.where(sel[:, None], out_h[0], X)
            else:
                X = (jnp.where(sel[:, None], out_h[0], X[0]),
                     jnp.where(sel[:, None], out_h[1], X[1]))
            rep = OmpReportArrays(
                iter=jnp.where(sel, rh.iter, rep.iter),
                solution_error=jnp.where(sel, rh.solution_error,
                                         rep.solution_error))
    if not dense:
        return X[0], X[1], rep
    return X, rep


def _gram_psum(A_local):
    """AᵀA of a row-sharded A inside shard_map: local gemm at HIGHEST,
    one psum over the row axis."""
    with blas.precision_scope("highest"):
        return jax.lax.psum(blas.xgemm(A_local, A_local, trans_a=True),
                            ROW_AXIS)


@functools.lru_cache(maxsize=32)
def _gram_replicated_fn(mesh: Mesh):
    @partial(shard_map, mesh=mesh, in_specs=(P(ROW_AXIS, None),),
             out_specs=P(None, None), check_vma=False)
    def run(A_local):
        return _gram_psum(A_local)
    return jax.jit(run)


def gram_replicated(mesh: Mesh, A: jnp.ndarray) -> jnp.ndarray:
    """AᵀA of a row-sharded A, replicated on every device — one psum'd
    gemm. The mesh façade's construct-once Gram (api.Homotopy/Omp with
    ``mesh=``): computed once at HIGHEST precision (the unsharded
    ``_lazy_gram`` convention) and passed into every ``*_sharded`` call
    via their ``G=`` argument, so serving calls skip the per-call
    build."""
    return _gram_replicated_fn(mesh)(A)


@functools.lru_cache(maxsize=32)
def _update_column_fn(mesh: Mesh, with_gram: bool):
    """Cached jitted in-place column replacement on the mesh (the
    façades' serving gallery churn — api._update_column_impl): column j
    of the row-sharded A is rewritten shard-locally from the row-sharded
    new column, and the replicated Gram's row/column j is rebuilt with
    ONE psum'd Aᵀv gemv — the single-device incremental rewrite
    (api.py upd) at mesh scale, instead of re-placing A and re-psumming
    the full n² Gram."""
    g_spec = (P(None, None),) if with_gram else ()

    @partial(shard_map, mesh=mesh,
             in_specs=(P(ROW_AXIS, None),) + g_spec + (P(ROW_AXIS), P()),
             out_specs=((P(ROW_AXIS, None), P(None, None)) if with_gram
                        else P(ROW_AXIS, None)),
             check_vma=False)
    def run(A_local, *rest):
        if with_gram:
            G, v_local, j = rest
        else:
            v_local, j = rest
        A2 = jax.lax.dynamic_update_slice(A_local, v_local[:, None],
                                          (jnp.int32(0), j))
        if not with_gram:
            return A2
        with blas.precision_scope("highest"):
            g = jax.lax.psum(blas.xgemv(A2, v_local, trans=True),
                             ROW_AXIS)
        G2 = jax.lax.dynamic_update_slice(G, g[:, None], (jnp.int32(0), j))
        G2 = jax.lax.dynamic_update_slice(G2, g[None, :], (j, jnp.int32(0)))
        return A2, G2

    return jax.jit(run)


def update_column_sharded(mesh: Mesh, A: jnp.ndarray, G, v, j: int):
    """Replace column j of a row-sharded A (and the replicated Gram's
    row/col, if held) in place on the mesh. ``v`` is the (m,) new
    column at the UNPADDED row count; rows are padded to A's placed
    count with zeros (inert). Returns (A2, G2) with G2=None when G is
    None."""
    v = jnp.asarray(v)
    extra = A.shape[0] - v.shape[0]
    if extra:
        v = jnp.pad(v, ((0, extra),))
    v = jax.device_put(v, NamedSharding(mesh, P(ROW_AXIS)))
    fn = _update_column_fn(mesh, G is not None)
    j = jnp.asarray(j, jnp.int32)
    if G is None:
        return fn(A, v, j), None
    return fn(A, G, v, j)


@functools.lru_cache(maxsize=32)
def _qr_sharded_fn(mesh: Mesh, passes: int):
    """Cached jitted shard_map'd CholeskyQR factorization (see
    qr_sharded)."""

    @partial(shard_map, mesh=mesh,
             in_specs=(P(ROW_AXIS, None),),
             out_specs=(P(ROW_AXIS, None), P(None, None)),
             check_vma=False)
    def run(A_local):
        n = A_local.shape[1]
        eye = jnp.eye(n, dtype=A_local.dtype)
        with blas.precision_scope("highest"):
            Q, R = A_local, eye
            for _ in range(passes):
                # Gram psum → replicated Cholesky → local Q·R₁⁻¹ gemm:
                # the only collective per pass is the (n, n) psum; the
                # O(m·n²) work is local gemms (vs. the reference's
                # sequential Householder sweep, qr_decomposition.h:
                # 94-137, which is unshardable over rows)
                G = jax.lax.psum(blas.xgemm(Q, Q, trans_a=True), ROW_AXIS)
                R1 = jnp.linalg.cholesky(G).T          # upper, positive diag
                R1inv = blas.xtrsm(R1, eye, lower=False)
                Q = blas.xgemm(Q, R1inv)
                R = blas.xgemm(R1, R)
        return Q, R

    return jax.jit(run)


def qr_sharded(mesh: Mesh, A: jnp.ndarray, passes: int = 2):
    """Mesh-native economy QR of a row-sharded A (m, n), m ≥ n —
    CholeskyQR2.

    Returns ``(Q, R)``: Q (m_padded, n) row-sharded over the "row" axis,
    R (n, n) upper-triangular with positive diagonal, replicated. Each
    pass computes the replicated Gram QᵀQ with ONE (n, n) psum over the
    row shards, Cholesky-factors it locally, and applies R₁⁻¹ as a
    local gemm; ``passes=2`` (CholeskyQR2) squares away the first
    pass's κ(A)-dependent orthogonality loss, reaching Householder-
    grade ‖QᵀQ−I‖ for κ(A) ≲ 1/√eps (tests/test_sharding.py pins
    QᵀQ≈I, QR≈A and LS-solve parity vs np.linalg.qr at the reference
    tolerances in f32+f64).

    This closes the reference's construct-once amortization
    (src/lib.cpp:51-57 — the QR computed once in ``irls_state``) at
    mesh scale, where a host ``np.linalg.qr`` of the gathered A is
    infeasible. Rows are zero-padded to the row-axis multiple (inert:
    zero rows change neither QᵀQ nor any Qᵀy product, and their Q rows
    come out exactly zero); the returned Q keeps the padded row count
    so it feeds ``irls_sharded`` / ``shard_inputs`` without a reshard.

    The positive-diagonal R is the canonical QR sign convention; IRLS
    is invariant to it (api.Irls._qr). Requires full column rank —
    rank deficiency surfaces as NaNs from the first Cholesky (the
    reference's QR asserts m ≥ n and divides by a zero pivot there,
    qr_decomposition.h:101,227)."""
    m, n = A.shape
    if m < n:
        raise ValueError(
            f"qr_sharded requires m >= n (economy QR); got {m}x{n}")
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    A = jnp.asarray(A)
    A, _pad = _pad_rows(A, mesh)
    A = jax.device_put(A, NamedSharding(mesh, P(ROW_AXIS, None)))
    return _qr_sharded_fn(mesh, passes)(A)


def irls_sharded_from_a(mesh: Mesh, A: jnp.ndarray, Y: jnp.ndarray,
                        tolerance, max_iterations: int, **kwargs):
    """irls_sharded constructed directly from a row-sharded A: the
    economy QR comes from ``qr_sharded`` (CholeskyQR2 — no host
    factorization anywhere), then the solve proceeds sharded. For the
    construct-once shape (factor once, solve many), hold the
    ``qr_sharded`` result and call ``irls_sharded`` per batch — or use
    ``api.Irls(A, mesh=...)``."""
    Q, R = qr_sharded(mesh, A)
    return irls_sharded(mesh, Q, R, Y, tolerance, max_iterations,
                        **kwargs)


@functools.lru_cache(maxsize=64)
def _cosamp_sharded_fn(mesh: Mesh, precision: str, k_sparsity: int,
                       max_iterations: int, m_global: int):
    from ..solvers.cosamp import solve_cosamp

    @partial(shard_map, mesh=mesh,
             in_specs=(P(ROW_AXIS, None), P(DATA_AXIS, ROW_AXIS), P()),
             out_specs=(P(DATA_AXIS, None), (P(DATA_AXIS), P(DATA_AXIS))),
             check_vma=False)
    def run(A_local, Y_local, tol):
        with blas.precision_scope(precision):
            solve = lambda y_local: solve_cosamp(
                A_local, y_local, k_sparsity, tol,
                max_iterations=max_iterations, axis=ROW_AXIS,
                m_global=m_global)
            X, rep = jax.vmap(solve, in_axes=(0,))(Y_local)
        return X, (rep.iter, rep.solution_error)

    return jax.jit(run)


def cosamp_sharded(mesh: Mesh, A: jnp.ndarray, Y: jnp.ndarray,
                   k_sparsity: int, tolerance, max_iterations: int = 20,
                   precision: str = "highest",
                   m_global: int | None = None):
    """Row-sharded, batch-sharded CoSaMP (solvers/cosamp.py — the
    support-replacing greedy family) over the (data, row) mesh layout:
    per round, the proxy correlations c = Aᵀr, the ≤ 3k-union Gram BᵀB,
    the rhs Bᵀy and ‖r‖² each psum once over the row shards; the
    replicated S×S Cholesky, selection and prune are identical
    deterministic functions of the psum'd values on every shard. The
    pool clamp sizes by the TRUE (unpadded) row count — pass
    ``m_global`` when A arrives already row-padded (the façade does;
    reading it off a padded A inflated the clamp and made the union
    Gram singular whenever the m−k term bound — review finding).
    Returns (X (batch, n) data-sharded, OmpReportArrays)."""
    from ..api import _check_max_iterations
    _check_max_iterations(max_iterations)
    if precision not in ("highest", "high", "default"):
        raise ValueError(
            "precision must be 'highest', 'high' or 'default', "
            f"got {precision!r}")
    if m_global is None:
        m_global = A.shape[0]
    A, pad = _pad_rows(A, mesh)
    extra = A.shape[0] - Y.shape[1]
    Y = jnp.pad(Y, ((0, 0), (0, extra))) if extra else Y
    fn = _cosamp_sharded_fn(mesh, precision, int(k_sparsity),
                            max_iterations, m_global)
    X, (iters, errs) = fn(A, Y, jnp.asarray(tolerance, A.dtype))
    from ..solvers.omp import OmpReportArrays
    return X, OmpReportArrays(iter=iters, solution_error=errs)


def irls_sharded(mesh: Mesh, Q: jnp.ndarray, R: jnp.ndarray, Y: jnp.ndarray,
                 tolerance, max_iterations: int, mode: str = "fast",
                 newton: str | None = None, stabilized: bool = False):
    """Row-sharded, batch-sharded IRLS solve given the economy QR of A.

    Q: (m, n) row-sharded; R: (n, n) replicated; Y: (batch, m).
    In mode="fast" the only collective in the whole solve is the single
    psum of rhs = Qᵀy — every iteration is replicated O(n²) work.

    ``newton`` (fast mode; default "trsm" — trsm keeps the fp trajectory
    of single solves)
    selects the Newton application like the unsharded batched path:
    "gemm" inverts the replicated R once per call and applies it as one
    gemm per iteration across the local lanes (solvers/irls.py
    _newton_fast — full-f32, algebraically identical).

    ``stabilized`` selects the scale-stabilized iteration (see
    ``api.Irls``; the per-lane max is lane-local state, so nothing
    about the communication contract changes).
    """
    from ..api import _check_max_iterations
    _check_max_iterations(max_iterations)
    if newton not in (None, "trsm", "gemm"):
        raise ValueError(f"newton must be 'trsm' or 'gemm', got {newton!r}")
    if newton is None:
        newton = "trsm"
    use_rinv = mode == "fast" and newton == "gemm"
    Q, pad = _pad_rows(Q, mesh)
    # qr_sharded returns Q pre-padded to the row-axis multiple; pad Y up
    # to Q's row count either way (zero y rows meet zero Q rows — Qᵀy is
    # unchanged)
    extra = Q.shape[0] - Y.shape[1]
    Y = jnp.pad(Y, ((0, 0), (0, extra))) if extra else Y

    fn = _irls_sharded_fn(mesh, mode, use_rinv, max_iterations,
                          bool(stabilized))
    X, (iters, errs, spd) = fn(Q, R, Y, jnp.asarray(tolerance, Q.dtype))
    from ..solvers.irls import IrlsReportArrays
    return X, IrlsReportArrays(iter=iters, solution_error=errs,
                               spd_failure=spd)


@functools.lru_cache(maxsize=128)
def _irls_sharded_fn(mesh: Mesh, mode: str, use_rinv: bool,
                     max_iterations: int, stabilized: bool = False):
    """Cached jitted shard_map'd IRLS solve (see _homotopy_sharded_fn)."""

    @partial(shard_map, mesh=mesh,
             in_specs=(P(ROW_AXIS, None), P(None, None),
                       P(DATA_AXIS, ROW_AXIS), P()),
             out_specs=(P(DATA_AXIS, None),
                        (P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS))),
             check_vma=False)
    def run(Q_local, R_rep, Y_local, tol):
        qop = RowShardedOperator(Q_local, ROW_AXIS)
        r_inv = (blas.xtrsm(R_rep, jnp.eye(R_rep.shape[0], dtype=R_rep.dtype),
                            lower=False) if use_rinv else None)
        solve = lambda y_local: solve_irls_core(
            qop, R_rep, y_local, tol, max_iterations, mode=mode,
            r_inv=r_inv, stabilized=stabilized)
        X, rep = jax.vmap(solve, in_axes=(0,))(Y_local)
        return X, (rep.iter, rep.solution_error, rep.spd_failure)

    return jax.jit(run)


def irls_cg_sharded(mesh: Mesh, A: jnp.ndarray, Y: jnp.ndarray, tolerance,
                    max_iterations: int, *, p: float = 1.0,
                    k_sparsity: int | None = None,
                    cg_max_iterations: int | None = None,
                    cg_tolerance: float | None = None):
    """Column-sharded, batch-sharded CG-IRLS (solvers/irls_cg.py).

    A: (m, n) — **columns** sharded over the "row" mesh axis (the tensor
    axis; in the underdetermined basis-pursuit regime n is the large
    dimension, so the n axis is what must be partitioned — the axis name
    is just the mesh's tensor axis). Y: (batch, m) — batch over "data",
    m replicated. Returns (X: (batch, n), IrlsReportArrays).

    Every m-sized CG iterate is replicated; x/weights stay column-
    sharded; exactly one psum (of A·(D∘Aᵀz), m floats) crosses devices per CG
    step, plus one tiny all_gather per outer step for the global
    (K+1)-th order statistic of |x| (the ε rule).

    Zero-column padding (to the mesh multiple) is inert: a zero column
    contributes D_j·a_j a_jᵀ = 0 to A D Aᵀ and its x_j = D_j·(Aᵀz)_j = 0.
    """
    from ..api import _check_max_iterations
    _check_max_iterations(max_iterations)

    m, n = A.shape
    n_dev = mesh.shape[ROW_AXIS]
    pad = (-n) % n_dev
    if pad:
        A = jnp.pad(A, ((0, 0), (0, pad)))

    fn = _irls_cg_sharded_fn(mesh, n, max_iterations, p, k_sparsity,
                             cg_max_iterations, cg_tolerance)
    X, (iters, errs, spd) = fn(A, Y, jnp.asarray(tolerance, A.dtype))
    if pad:
        X = X[:, :n]
    from ..solvers.irls import IrlsReportArrays
    return X, IrlsReportArrays(iter=iters, solution_error=errs,
                               spd_failure=spd)


@functools.lru_cache(maxsize=128)
def _irls_cg_sharded_fn(mesh: Mesh, n: int, max_iterations: int, p: float,
                        k_sparsity: int | None, cg_max_iterations: int | None,
                        cg_tolerance: float | None):
    """Cached jitted shard_map'd CG-IRLS solve (see _homotopy_sharded_fn).
    ``n`` is the true (unpadded) column count; padded shapes are read off
    the local shard."""
    from ..ops.operators import ColShardedOperator
    from ..solvers.irls_cg import solve_irls_cg_core

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, ROW_AXIS), P(DATA_AXIS, None), P()),
             out_specs=(P(DATA_AXIS, ROW_AXIS),
                        (P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS))),
             check_vma=False)
    def run(A_local, Y_local, tol):
        m, n_local = A_local.shape
        op = ColShardedOperator(A_local, ROW_AXIS)
        solve = lambda y: solve_irls_cg_core(
            op.matvec, op.rmatvec, m, n, y, tol, max_iterations,
            p=p, k_sparsity=k_sparsity, cg_max_iterations=cg_max_iterations,
            cg_tolerance=cg_tolerance, dtype=A_local.dtype,
            n_local=n_local, n_axis=ROW_AXIS)
        X, rep = jax.vmap(solve)(Y_local)
        return X, (rep.iter, rep.solution_error, rep.spd_failure)

    return jax.jit(run)


def shard_inputs(mesh: Mesh, A: jnp.ndarray, Y: jnp.ndarray):
    """Pad rows to the row-axis multiple, then place A row-sharded and
    Y (batch, m) batch+row sharded on the mesh. Zero row padding does not
    change Aᵀ(y−Ax), AᵀA, or QᵀQ products, so solver results are
    unaffected."""
    A = jnp.asarray(A)
    Y = jnp.asarray(Y)
    A, pad = _pad_rows(A, mesh)
    if pad:
        Y = jnp.pad(Y, ((0, 0), (0, pad)))
    A = jax.device_put(A, NamedSharding(mesh, P(ROW_AXIS, None)))
    Y = jax.device_put(Y, NamedSharding(mesh, P(DATA_AXIS, ROW_AXIS)))
    return A, Y
