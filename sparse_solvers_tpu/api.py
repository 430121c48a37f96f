"""Public solver API — construct-once / solve-many, matching the reference's
Python binding surface (reference: bindings/python/sparsesolvers/binding.cpp:
114-148): ``Homotopy(A)``, ``Irls(A)``, ``solver.solve(b, tolerance,
max_iterations) -> (x, report)``, plus ``reconstruct_signal`` and ``norm_l1``
(reference: include/ss/ss.h:79-93).

Device semantics:
  * the sensing matrix is placed on device once at construction; the IRLS
    QR and the homotopy Gram matrix are computed once on first jax-engine
    use and cached on device (the reference's amortized solver state,
    src/lib.cpp:51-57);
  * ``solve`` compiles per (max_iterations, k_max) and caches the executable;
    tolerance is a traced argument (no recompile);
  * ``solve_batch`` vmaps one compiled program over thousands of signals
    sharing A — the throughput path (face-recognition workload,
    BASELINE.json config 4);
  * dtype (float32/float64) follows the input matrix, as in the binding
    (binding.cpp:69-86). float64 requires jax x64 mode.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp

from .reports import HomotopyReport, IrlsReport, OmpReport
from .solvers import homotopy as _homotopy
from .solvers import homotopy_batch as _homotopy_batch
from .solvers import irls as _irls
from .utils import ndview
from .linalg import norms as _norms
from .ops import blas as _blas
from .ops import operators as _operators


def _default_tolerance(dtype) -> float:
    # reference binding default: 10 × machine epsilon (binding.cpp:108-110)
    return float(np.finfo(dtype).eps) * 10


# Gram matrices above this byte size are not precomputed automatically
# (n² entries; 1 GiB ⇒ n ≈ 16384 in float32).
_GRAM_AUTO_BYTES = 1 << 30

_PRECISION_VALUES = ("highest", "high", "default", "certified")


def path_precision_of(precision: str) -> str:
    """The precision the solve path itself runs at: "certified" runs
    the path one-pass ("default") and certifies the result afterwards."""
    return "default" if precision == "certified" else precision


def _certified_error(A, x, y):
    """Certificate: ‖Aᵀ(y − Ax)‖∞ at parity-grade precision
    (``blas.PARITY``, full FP32) — exactly the solver's own convergence
    criterion (reference: homotopy-cpu.cpp:270, c_inf via ixamax),
    recomputed from the returned solution with trustworthy arithmetic.
    Batched when x/y carry a leading batch axis."""
    with _blas.precision_scope(_blas.PARITY):
        if x.ndim == 2:                       # (b, n) against (b, m)
            r = y - _blas.xgemm(x, A, trans_b=True)
            c = _blas.xgemm(r, A)
        else:
            r = y - _blas.xgemv(A, x)
            c = _blas.xgemv(A, r, trans=True)
    return jnp.max(jnp.abs(c), axis=-1)


def _certified_l2_error(A, x, y):
    """ℓ₂ residual certificate ‖y − Ax‖₂ at parity-grade precision
    (``blas.PARITY``) — the greedy family's convergence criterion, recomputed
    from the returned solution (the OMP analog of ``_certified_error``;
    the driver and sharded legs fuse their own psum'd variants). Named
    so tests can monkeypatch it to force certificate failures and
    exercise the re-solve merge. Batched when x/y carry a batch axis."""
    with _blas.precision_scope(_blas.PARITY):
        if x.ndim == 2:
            r = y - _blas.xgemm(x, A, trans_b=True)
            return jnp.sqrt(jnp.maximum(jnp.sum(r * r, axis=1), 0))
        r = y - _blas.xgemv(A, x)
        return jnp.sqrt(jnp.maximum(jnp.sum(r * r), 0))


def _warn_small_problem_jax(engine: str, m: int, n: int) -> None:
    """Explicitly forcing engine="jax" below the dispatch-latency floor
    pays device dispatch and transfer for a solve the host finishes
    sooner; "auto" routes such problems to the native host engine. (The
    floor's size on the GPU is not measured yet, ROADMAP queue 1 #4.)"""
    if engine == "jax" and m * n <= Homotopy._NATIVE_AUTO_ELEMS:
        warnings.warn(
            f"engine='jax' on a {m}x{n} problem: device dispatch latency "
            "will dominate the solve; engine='auto' (default) uses the "
            "native host backend for problems this small",
            RuntimeWarning, stacklevel=3)


def _check_max_iterations(max_iterations: int) -> int:
    """The reference's caller contract (homotopy-cpu.cpp:193,
    irls-cpu.cpp:75: ``assert(max_iter > 0)``) as an edge ValueError —
    a zero budget has no defined do-while semantics and the engines
    would diverge on it."""
    if max_iterations < 1:
        raise ValueError(
            f"max_iterations must be >= 1, got {max_iterations}")
    return max_iterations


def _route_native(engine: str, m: int, n: int, probe: bool) -> bool:
    """Shared engine routing for the solver façades.

    ``probe=True`` answers without side effects (no lazy ``make``, no
    error on a missing build) — ``explain()``'s contract. Routing rule:
    honor an explicit ``engine="native"``; under ``"auto"``, problems
    below the device dispatch-latency floor go to the host backend.
    """
    from .backend import native as _native  # local: optional build
    if not _native.available(build=not probe):
        if engine == "native":
            if probe:
                return True  # a solve would attempt (and report) it
            raise RuntimeError(
                "native engine requested but the host backend is "
                "unavailable (build failed or SS_NATIVE_DISABLE=1)")
        return False
    return engine == "native" or m * n <= Homotopy._NATIVE_AUTO_ELEMS


def _lazy_gram(solver):
    """Shared lazy AᵀA for the Gram-using facades (Homotopy, Omp):
    computed on first jax-engine use so construction stays device-free;
    a first touch inside an outer jit trace returns the traced value
    without caching it (a cached tracer would leak into later eager
    solves)."""
    if solver._gram_enabled and solver._G_cache is None:
        G = jax.jit(_blas.xgemm, static_argnames="trans_a")(
            solver._A, solver._A, trans_a=True)
        if isinstance(G, jax.core.Tracer):
            return G
        solver._G_cache = G
    return solver._G_cache


def _check_mesh(mesh, engine: str):
    """Validate the façades' ``mesh=`` argument (jax.sharding.Mesh with
    the framework's ("data", "row") axes — parallel.sharding.make_mesh
    builds one). Mesh-sharded solving runs the fast-path formulations on
    the jax engine."""
    from jax.sharding import Mesh
    from .parallel import sharding as _sh
    if not isinstance(mesh, Mesh):
        raise ValueError(
            f"mesh must be a jax.sharding.Mesh, got {type(mesh).__name__}")
    for ax in (_sh.DATA_AXIS, _sh.ROW_AXIS):
        if ax not in mesh.shape:
            raise ValueError(
                f"mesh must carry the ('{_sh.DATA_AXIS}', "
                f"'{_sh.ROW_AXIS}') axes (use parallel.sharding."
                f"make_mesh); got axes {tuple(mesh.shape)}")
    if engine == "native":
        raise ValueError(
            "mesh-sharded solving runs on the jax engine; drop "
            "engine='native' or the mesh")


def _mesh_place_rows(mesh, A):
    """Pad A's rows to the row-axis multiple and place it row-sharded
    (the construct-once placement of the mesh façades)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .parallel import sharding as _sh
    A, _pad = _sh._pad_rows(jnp.asarray(A), mesh)
    return jax.device_put(A, NamedSharding(mesh, P(_sh.ROW_AXIS, None)))


def _mesh_prep_batch(mesh, Y, m_padded: int):
    """Pad a (batch, m) signal block to the mesh multiples (batch → the
    data axis, rows → the placed A's padded m) and place it
    (data, row)-sharded. Zero signals/rows are inert (they meet zero A
    rows / solve trivially and are trimmed from the results). Returns
    (Y_placed, batch_pad)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .parallel import sharding as _sh
    Y = jnp.asarray(Y)
    bpad = (-Y.shape[0]) % mesh.shape[_sh.DATA_AXIS]
    if bpad:
        Y = jnp.pad(Y, ((0, bpad), (0, 0)))
    extra = m_padded - Y.shape[1]
    if extra:
        Y = jnp.pad(Y, ((0, 0), (0, extra)))
    return jax.device_put(
        Y, NamedSharding(mesh, P(_sh.DATA_AXIS, _sh.ROW_AXIS))), bpad


def _mesh_pad_jit(mesh, Y, m_padded: int):
    """jit-safe (jnp-only) batch/row padding for the on-device mesh
    entries: batch to the data-axis multiple, rows to the placed A's
    padded count (zero pads are inert and trimmed from the results).
    Returns (Y_padded, batch_pad)."""
    from .parallel import sharding as _sh
    bpad = (-Y.shape[0]) % mesh.shape[_sh.DATA_AXIS]
    extra = m_padded - Y.shape[1]
    if bpad or extra:
        Y = jnp.pad(Y, ((0, bpad), (0, extra)))
    return Y, bpad


def _trim_batch(out, rep, bpad: int, dense: bool):
    """Drop the data-axis padding lanes from a sharded batch result."""
    if not bpad:
        return out, rep
    cut = lambda a: a[:-bpad]
    out = cut(out) if dense else (cut(out[0]), cut(out[1]))
    return out, type(rep)(**{f: cut(getattr(rep, f))
                             for f in rep._fields})


def _update_column_impl(solver, j: int, col) -> None:
    """Shared in-place sensing-column replacement (gallery churn) with
    the incremental Gram row/col rewrite — one Aᵀ·v product instead of
    the O(mn²) rebuild. See Homotopy.update_column for semantics."""
    if not (0 <= j < solver._n):
        raise ValueError(f"column index {j} out of range [0, {solver._n})")
    v = jnp.asarray(ndview.as_vector(col, dtype=solver.dtype,
                                     size=solver._m))
    with_g = solver._G_cache is not None
    fn = solver._cache.get(("colupd", with_g))
    if fn is None:
        def upd(A, v, j, G=None):
            A2 = A.at[:, j].set(v)
            if G is None:
                return A2, None
            # new Gram row/col: g = Aᵀ_new v (the already-updated
            # column makes the diagonal land as vᵀv)
            g = _blas.xgemv(A2, v, trans=True)
            return A2, G.at[:, j].set(g).at[j, :].set(g)
        fn = jax.jit(upd)  # one dispatch per churn op
        solver._cache[("colupd", with_g)] = fn
    if with_g:
        solver._A, solver._G_cache = fn(jnp.asarray(solver._A), v, j,
                                        solver._G_cache)
    else:
        solver._A, _ = fn(jnp.asarray(solver._A), v, j)
    if getattr(solver, "_mesh", None) is not None:
        if solver._A_mesh is not None:
            # incremental mesh rewrite: shard-local column set + ONE
            # psum'd Aᵀv gemv for the replicated Gram's row/col
            # (parallel.sharding.update_column_sharded) — the
            # single-device incremental update at mesh scale
            from .parallel import sharding as _sh
            solver._A_mesh, solver._G_mesh = _sh.update_column_sharded(
                solver._mesh, solver._A_mesh, solver._G_mesh, v, j)
        # else: nothing placed yet — the lazy placement reads the
        # already-updated host A


class Homotopy:
    """Homotopy path-following solver over a fixed sensing matrix A (m×n).

    Parameters
    ----------
    A : (m, n) array-like, float32 or float64.
    k_max : optional active-set capacity. Defaults per solve to
        min(n, max_iterations + 1), which is always sufficient (each
        iteration toggles at most one support index). Set it lower to trade
        exactness of the padded inverse buffer for speed/memory on very
        large problems.
    mode : "fast" (default) or "exact". Fast mode uses algebraically
        identical updates that avoid redundant passes over A (correlation
        recurrence, sparse-direction matvecs, precomputed Gram columns);
        exact mode reproduces the reference's per-iteration recomputation
        operation-for-operation (homotopy-cpu.cpp:236-272).
    gram : precompute AᵀA (fast-mode acceleration; computed lazily on
        first jax-engine solve). Default None = auto (on when n² fits in
        1 GiB). Ignored in exact mode.
    precision : matmul precision for the solve loop — "highest" (full
        FP32), "high" and "default" (TF32 on the GPU's tensor cores;
        the slot-space driver's "default" route computes its q product
        on a bf16 copy of A), or "certified" (mixed: the path runs at
        "default" speed, then the final correlation ‖Aᵀ(y−Ax)‖∞ — the
        solver's own convergence criterion — is recomputed at "highest"
        precision and reported as solution_error;
        ``solve``/``solve_batch`` automatically re-solve at "highest"
        precision if the certificate misses the tolerance — except for
        lanes that exhausted max_iterations, which are honestly
        non-convergent at any precision and reported as-is — so results
        are as trustworthy as precision="highest" while the common
        case runs one-pass fast). On the CPU every precision computes
        full float32. Solves routed to the native host engine compute in
        exact f32 FMA arithmetic, so certification adds nothing there
        and is skipped. Default None = "certified" in fast mode,
        "highest" in exact mode.
    engine : "jax" (accelerator/XLA), "native" (C++ host backend, csrc/),
        or "auto" (default) — native for problems small enough that a
        device dispatch dominates the solve itself, jax otherwise. The
        native engine implements the identical fast-path algorithm.
    mesh : optional ``jax.sharding.Mesh`` with ("data", "row") axes
        (parallel.sharding.make_mesh). The construct-once object form of
        the sharded functional API: A is placed row-sharded once at
        first use, the replicated Gram is psum'd once per mesh and
        cached, and ``solve``/``solve_batch`` route through
        ``parallel.sharding.homotopy_sharded`` (batch padded to the
        data-axis multiple and trimmed). ``explain()`` reports the mesh
        plan. Fast mode, jax engine only; ``solve_path*`` stays
        single-device.
    """

    # Below this m·n the device round trip (~200 µs) exceeds the host
    # solve time, so "auto" routes to the native backend.
    _NATIVE_AUTO_ELEMS = 1 << 16

    def __init__(self, A, k_max: int | None = None, mode: str = "fast",
                 gram: bool | None = None, precision: str | None = None,
                 engine: str = "auto", mesh=None):
        if mode not in ("fast", "exact"):
            raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
        if engine not in ("auto", "jax", "native"):
            raise ValueError(
                f"engine must be 'auto', 'jax' or 'native', got {engine!r}")
        if engine == "native" and mode == "exact":
            raise ValueError(
                "engine='native' implements the fast-path algorithm; "
                "mode='exact' requires the jax engine")
        if (precision is not None and isinstance(precision, str)
                and precision not in _PRECISION_VALUES):
            raise ValueError(
                f"precision must be one of {_PRECISION_VALUES}, "
                f"got {precision!r}")
        if precision == "certified" and mode == "exact":
            raise ValueError(
                "precision='certified' runs the path at one-pass "
                "precision; mode='exact' (operation-for-operation "
                "reference parity) requires 'high' or 'highest'")
        if mesh is not None:
            if mode == "exact":
                raise ValueError(
                    "mesh-sharded solving runs the fast-path "
                    "formulation; mode='exact' is single-device")
            _check_mesh(mesh, engine)
        self._engine = engine
        self._A = ndview.as_matrix(A)
        self._m, self._n = self._A.shape
        if mesh is None:
            _warn_small_problem_jax(engine, self._m, self._n)
        self._k_max = k_max
        self._mode = mode
        # Fast-mode default is "certified": the path at one-pass speed
        # with an equally trustworthy reported error — the certificate
        # IS a parity-grade ‖Aᵀ(y−Ax)‖∞ and failing lanes re-solve at
        # blas.PARITY. Tolerance semantics are unchanged (reference
        # defaults, binding.cpp:108-110).
        self._precision = precision or ("certified" if mode == "fast"
                                        else "highest")
        if gram is None:
            gram = (self._n * self._n * self._A.dtype.itemsize
                    <= _GRAM_AUTO_BYTES)
        self._gram_enabled = bool(gram and mode == "fast")
        self._G_cache = None
        self._mesh = mesh
        self._A_mesh = self._G_mesh = None  # lazy sharded placements
        self._cache: dict = {}

    @property
    def _G(self):
        """AᵀA, computed lazily on first jax-engine use (native-engine
        solves never touch it, so construction stays device-free)."""
        return _lazy_gram(self)

    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self):
        return self._A.dtype

    def update_column(self, j: int, col) -> None:
        """Replace column j of the sensing matrix in place (device).

        The serving-loop gallery-churn operation (BASELINE config 4's
        face-recognition workload: columns are gallery entries). The
        cached Gram matrix is updated incrementally — one Aᵀ·col product
        writes the changed row/column — instead of the O(mn²) rebuild,
        and the compiled executables are shape-keyed so they all stay
        valid. No reference analog: its solver holds a const view of A
        (policies.h:42), so callers there rebuild the solver.
        """
        _update_column_impl(self, j, col)

    def _mesh_arrays(self):
        """Construct-once sharded state: A placed row-sharded (padded to
        the row-axis multiple) and, when the Gram is enabled, the
        replicated AᵀA psum'd ONCE per mesh at highest precision
        (parallel.sharding.gram_replicated) — the reference's
        construct-once amortization (src/lib.cpp:51-57) extended to the
        mesh. Recomputed lazily after ``update_column``."""
        if self._A_mesh is None:
            from .parallel import sharding as _sh
            self._A_mesh = _mesh_place_rows(self._mesh, self._A)
            if self._gram_enabled:
                self._G_mesh = _sh.gram_replicated(self._mesh,
                                                   self._A_mesh)
        return self._A_mesh, self._G_mesh

    def _solve_batch_mesh(self, Y, tol, max_iterations: int,
                          dense: bool = True):
        from .parallel import sharding as _sh
        A, G = self._mesh_arrays()
        Yd, bpad = _mesh_prep_batch(self._mesh, Y, A.shape[0])
        k_max = self._k_max or min(self._n, max_iterations + 1)
        out = _sh.homotopy_sharded(
            self._mesh, A, Yd, tol, max_iterations, k_max=k_max,
            gram=self._gram_enabled if G is None else None, G=G,
            precision=self._precision, dense=dense)
        rep = out[-1]
        X = out[0] if dense else (out[0], out[1])
        X, rep = _trim_batch(X, rep, bpad, dense)
        if not dense:
            return X[0], X[1], rep
        return X, rep

    def _plan(self, max_iterations: int, batch: int | None,
              record_path: bool = False):
        """Routing decisions for a jax-engine solve of this shape —
        (k_max, sparse_matvec, batch_native). Shared by the compiled-
        program cache and by ``explain`` so the report cannot drift from
        the executed path. ``record_path`` solves (solve_path /
        solve_path_batch) route like ordinary solves: the batch driver
        records breakpoint histories in its own slot space, so batched
        path extraction runs at throughput-path speed (single-signal
        record_path keeps the while-loop core — there is no batch)."""
        k_max = self._k_max or min(self._n, max_iterations + 1)
        # Sparse (gather-based) A·d only wins while the gathered column
        # traffic (batch·k_max columns) is below a couple of full passes
        # over A (2m columns' worth per product it replaces).
        sparse = (self._mode == "fast"
                  and (batch or 1) * k_max < 2 * self._m
                  and k_max < self._n)
        # Batch-native driver (slot-space state, solvers/
        # homotopy_batch.py) — the throughput path for fast-mode batches
        # on the GPU; the CPU keeps the vmapped core. Routing shared with
        # homotopy_sharded, Omp and omp_sharded (homotopy_batch.
        # route_batch_native). Without a Gram matrix the driver runs
        # gram-free (on-the-fly active-set Gram entries — the large-n
        # regime).
        batch_native = (self._mode == "fast"
                        and _homotopy_batch.route_batch_native(
                            batch, self._A.dtype, sparse))
        return k_max, sparse, batch_native

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan for a solve of this configuration — which
        engine and which compiled formulation would run, so users can
        see (rather than guess) whether the slot-space batch driver,
        the vmapped core, or the native host backend carries the solve.

        Pass ``batch`` (lane count) for ``solve_batch`` plans, None for
        single solves. Side-effect-free report: no compilation, no lazy
        native build (reading the backend name may initialize the JAX
        client on first use, as any jax call does)."""
        if self._use_native(probe=True):
            return {"engine": "native", "mode": self._mode,
                    "backend": "csrc host (C++)"}
        if self._mesh is not None:
            from .parallel import sharding as _sh
            S = self._mesh.shape[_sh.ROW_AXIS]
            k_max = self._k_max or min(self._n, max_iterations + 1)
            local_b = -(-(batch or 1) // self._mesh.shape[_sh.DATA_AXIS])
            # the padded row count — the m the sharded route actually
            # tests its crossovers against (review finding)
            m_pad = self._m + ((-self._m) % S)
            sparse = (self._gram_enabled
                      and local_b * k_max < 2 * m_pad and k_max < self._n)
            bn = _homotopy_batch.route_batch_native(
                local_b, self._A.dtype, sparse)
            plan = {"engine": "jax", "backend": jax.default_backend(),
                    "mode": self._mode, "precision": self._precision,
                    "mesh": dict(self._mesh.shape), "sharded": True,
                    "gram": self._gram_enabled,
                    "gram_cached": self._G_mesh is not None,
                    "k_max": k_max, "batch_native": bn,
                    "overlap_mode": ("ppermute"
                                     if bn and S > 1 and self._n >= 128 * S
                                     else "psum"),
                    "formulation": ("row+data shard_map solve "
                                    "(parallel/sharding.homotopy_sharded"
                                    + (", slot-space driver)" if bn
                                       else ", vmapped core)"))}
            if self._precision == "certified":
                plan["path_precision"] = "default"
                plan["certificate"] = ("psum'd ‖Aᵀ(y−Ax)‖∞ at highest "
                                       "precision; failing lanes re-solve")
            return plan
        k_max, sparse, batch_native = self._plan(max_iterations, batch)
        plan = {
            "engine": "jax",
            "backend": jax.default_backend(),
            "mode": self._mode,
            "precision": self._precision,
            "gram": self._gram_enabled,
            "k_max": k_max,
            "sparse_matvec": sparse,
            "batch_native": batch_native,
            "formulation": (
                "slot-space batch driver (plain-XLA scan + transition)"
                if batch_native else
                ("vmapped while_loop core" if batch is not None
                 else "while_loop core")),
        }
        if self._precision == "certified":
            plan["path_precision"] = "default"
            plan["certificate"] = ("‖Aᵀ(y−Ax)‖∞ at highest precision; "
                                   "solve/solve_batch re-solve lanes "
                                   "that miss the tolerance")
        if batch_native:
            plan["capacity_tiers"] = _homotopy_batch._plan_tiers(
                k_max, max_iterations, None)
            if not self._gram_enabled:
                plan["gram_free"] = True  # on-the-fly Gram rows
            if batch is not None:
                with _blas.precision_scope(path_precision_of(
                        self._precision)):
                    plan["bf16_q"] = _homotopy_batch.default_bf16_q()
        return plan

    def _fn(self, max_iterations: int, batch: int | None,
            precision: str | None = None, record_path: bool = False,
            dense: bool = True):
        """Compiled solve program. ``precision`` overrides the instance
        setting (used by the certified re-solve path); ``record_path``
        runs with breakpoint recording and returns (x, report,
        histories) — the solve_path/solve_path_batch entry; ``dense=
        False`` (batch-native only) returns the compact slot-space
        solution ((values, indices), report) without the (b, n)
        scatter."""
        _check_max_iterations(max_iterations)
        precision = precision or self._precision
        certified = precision == "certified"
        if record_path and certified:
            raise ValueError(
                "record_path needs a concrete precision "
                "(solve_path resolves certified to 'high')")
        # certified mode: the path itself runs at one-pass ("default")
        # precision; the certificate below restores trust in the result
        path_precision = path_precision_of(precision)
        k_max, sparse, batch_native = self._plan(max_iterations, batch,
                                                 record_path=record_path)
        key = (max_iterations, k_max, batch is not None, sparse,
               batch_native, precision, record_path, dense)
        fn = self._cache.get(key)
        if fn is None:
            if batch_native:
                def path(A, G, y, tol):
                    with _blas.precision_scope(path_precision):
                        return _homotopy_batch.solve_homotopy_batch(
                            A, G, y, tol, max_iterations, k_max,
                            dense=dense, record_path=record_path)
            else:
                def core(A, G, y, tol):
                    op = _operators.DenseOperator(A, G)
                    with _blas.precision_scope(path_precision):
                        return _homotopy.solve_homotopy_core(
                            op, self._n, y, tol, max_iterations, k_max,
                            mode=self._mode, sparse_matvec=sparse,
                            record_path=record_path, compact=not dense)
                path = core
                if batch is not None:
                    path = jax.vmap(core, in_axes=(None, None, 0, None))
            if certified:
                # the certificate is fused into the path's executable:
                # one dispatch per batch, and no second program to
                # compile
                def run(A, G, y, tol):
                    out, rep = path(A, G, y, tol)
                    # compact output: densify on device for the
                    # certificate only (the transfer saving of
                    # dense=False is device→host, not device compute)
                    x = (out if dense else
                         _homotopy_batch.densify_batch(out[0], out[1],
                                                       self._n))
                    err = _certified_error(A, x, y)
                    return out, rep._replace(
                        solution_error=err.astype(rep.solution_error.dtype))
            else:
                run = path
            fn = jax.jit(run)
            self._cache[key] = fn
        return fn

    def _use_native(self, probe: bool = False) -> bool:
        # exact mode is jax-only: the native engine implements the fast
        # path, not the reference's per-iteration recomputation
        if (self._engine == "jax" or self._mode == "exact"
                or self._mesh is not None):
            return False
        return _route_native(self._engine, self._m, self._n, probe)

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Solve min‖x‖₁ s.t. Ax = b; returns (x, HomotopyReport)."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._mesh is not None:
            X, rep = self._solve_batch_mesh(y[None, :], tol,
                                            max_iterations)
            x, it, err = jax.device_get(
                (X[0], rep.iter[0], rep.solution_error[0]))
            return x, HomotopyReport(iter=int(it),
                                     solution_error=float(err))
        if self._use_native():
            from .backend import native as _native
            k_max = self._k_max or min(self._n, max_iterations + 1)
            xn, it, err = _native.homotopy_solve(
                np.asarray(self._A), np.asarray(y), tol, max_iterations,
                k_max)
            return xn, HomotopyReport(iter=it, solution_error=err)
        x, rep = self._fn(max_iterations, batch=None)(
            self._A, self._G, y, tol)
        # one fused device→host transfer (separate int()/float()/asarray
        # pulls cost a blocking round trip each)
        x, it, err = jax.device_get((x, rep.iter, rep.solution_error))
        # NaN-safe predicate (~(err <= tol), not err > tol): a
        # rank-deficient path can emit a non-finite certificate, which
        # must count as failing. Lanes that exhausted max_iterations are
        # reported as-is — no precision fixes an iteration budget.
        if (self._precision == "certified" and not (err <= tol)
                and int(it) < max_iterations):
            # the one-pass path missed the tolerance under parity-grade
            # scrutiny: re-solve at blas.PARITY (certified's guarantee)
            x, rep = self._fn(max_iterations, batch=None,
                              precision=_blas.PARITY)(self._A, self._G, y,
                                                      tol)
            x, it, err = jax.device_get((x, rep.iter, rep.solution_error))
        return x, HomotopyReport(iter=int(it), solution_error=float(err))

    def solve_path(self, b, tolerance: float | None = None,
                   max_iterations: int = 100):
        """The LARS/LASSO regularization path (beyond reference).

        The homotopy loop already visits every breakpoint of
        min ½‖y−Ax‖² + λ‖x‖₁ as λ decreases from ‖Aᵀy‖∞ to the
        tolerance; this records them instead of returning only the
        endpoint. Returns ``(lambdas, Xs, HomotopyReport)``: λ_t is the
        loop's own ‖Aᵀ(y−Ax_t)‖∞ at each committed breakpoint (λ₀ =
        ‖Aᵀy‖∞ at x₀ = 0; a break iteration commits nothing and its
        duplicate row is trimmed), and ``Xs[t]`` satisfies that KKT
        identity exactly. λ decreases monotonically on well-posed
        instances; on adversarial ones the reference's initial-direction
        quirk (sign(‖c‖∞)=+1 even for a negative max correlation,
        homotopy-cpu.cpp:223-227) can transiently raise it — recorded
        as-is. One compiled solve's cost plus a compact
        (max_iterations+1, k_max) slot-space history.
        Runs on the jax engine; ``precision="certified"`` paths record
        at parity-grade precision (the per-breakpoint iterates
        are the product here — a one-pass trajectory would certify only
        the endpoint).
        """
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._mesh is not None:
            raise ValueError(
                "solve_path is single-device (the breakpoint history is "
                "not plumbed through the sharded drivers); construct "
                "without mesh= for path extraction")
        precision = (_blas.PARITY if self._precision == "certified"
                     else self._precision)
        fn = self._fn(max_iterations, batch=None, precision=precision,
                      record_path=True)
        x, rep, (hv, hi, hl) = fn(self._A, self._G, y, tol)
        x, it, err, hv, hi, hl = jax.device_get(
            (x, rep.iter, rep.solution_error, hv, hi, hl))
        lam, Xs = densify_path(hl, hv, hi, int(it), self._n)
        return (lam, Xs,
                HomotopyReport(iter=int(it), solution_error=float(err)))

    def solve_path_batch(self, B, tolerance: float | None = None,
                         max_iterations: int = 100):
        """Batched regularization paths (see ``solve_path``) over signals
        B of shape (batch, m), sharing one compiled program.

        Returns ``(lambdas, values, indices, reports)`` in the compact
        slot-space history form — dense (batch, T, n) sweeps would be
        enormous, so lane ``l``'s breakpoint ``t`` holds solution values
        ``values[l, t, j]`` at columns ``indices[l, t, j]`` (sentinel n =
        empty slot), with ``lambdas[l, t]`` its λ; rows beyond
        ``reports.iter[l]`` are padding. ``densify_path(lambdas[l],
        values[l], indices[l], int(reports.iter[l]), n)`` reconstructs
        one lane's dense (T, n) path (and trims the duplicate row of a
        break-terminated lane)."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._mesh is not None:
            raise ValueError(
                "solve_path_batch is single-device (the breakpoint "
                "history is not plumbed through the sharded drivers); "
                "construct without mesh= for path extraction")
        precision = (_blas.PARITY if self._precision == "certified"
                     else self._precision)
        fn = self._fn(max_iterations, batch=Y.shape[0], precision=precision,
                      record_path=True)
        X, rep, (hv, hi, hl) = fn(self._A, self._G, Y, tol)
        # ONE fused device->host transfer: per-lane densify_path reads
        # would otherwise each pay a blocking round trip
        hl, hv, hi, it, err = jax.device_get(
            (hl, hv, hi, rep.iter, rep.solution_error))
        return hl, hv, hi, _homotopy.HomotopyReportArrays(
            iter=it, solution_error=err)

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100, dense: bool = True):
        """Batched solve over signals B of shape (batch, m).

        Returns (X of shape (batch, n), HomotopyReportArrays pytree with
        per-lane iter/solution_error arrays).

        ``dense=False`` returns ``(values, indices, report)`` — the
        compact slot-space solution: per lane, ``values[l, j]`` at
        column ``indices[l, j]`` (sentinel n = empty slot), shapes
        (batch, k_max). The batch driver holds exactly this state, so
        the (batch, n) scatter AND its dense device→host transfer are
        skipped — at the gram-free config-5 scale (n = 131072, b = 128)
        that is 64 MiB of transfer for ~16 K actual nonzeros (north-star
        CSR ask, BASELINE.json). ``densify_batch(values, indices, n)``
        reconstructs the dense X exactly.
        """
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._mesh is not None:
            return self._solve_batch_mesh(Y, tol, max_iterations, dense)
        if self._use_native():
            from .backend import native as _native
            k_max = self._k_max or min(self._n, max_iterations + 1)
            X, iters, errs = _native.homotopy_solve_batch(
                np.asarray(self._A), np.asarray(Y), tol,
                max_iterations, k_max)
            rep = _homotopy.HomotopyReportArrays(
                iter=iters.astype(np.uint32), solution_error=errs)
            if not dense:
                vals, idxs = _compact_from_dense(X, k_max)
                return vals, idxs, rep
            return X, rep
        X, rep = self._fn(max_iterations, batch=Y.shape[0], dense=dense)(
            self._A, self._G, Y, tol)
        if self._precision == "certified":
            # lanes whose parity-grade certificate misses the tolerance
            # are re-solved at blas.PARITY. The re-solve covers the full batch
            # (shape-stable: reuses one cached executable regardless of
            # how many lanes failed) and the merge keeps the fast result
            # everywhere the certificate held. Failures are rare by
            # construction — a lane fails only when the tolerance sits
            # within one-pass resolution of the problem's scale.
            # NaN-safe predicate: a non-finite certificate counts as
            # failing. Lanes that exhausted max_iterations are excluded
            # (honestly non-convergent at any precision — re-solving
            # them every call would double serving cost forever; the
            # narrow corner of a lane converging exactly on the last
            # allowed iteration under bf16 is reported as-is).
            errs = np.asarray(rep.solution_error)
            bad = (~(errs <= tol)) & (
                np.asarray(rep.iter) < max_iterations)
            if bad.any():
                Xh, reph = self._fn(max_iterations, batch=Y.shape[0],
                                    precision=_blas.PARITY, dense=dense)(
                    self._A, self._G, Y, tol)
                sel = jnp.asarray(bad)
                if dense:
                    X = jnp.where(sel[:, None], Xh, X)
                else:
                    X = (jnp.where(sel[:, None], Xh[0], X[0]),
                         jnp.where(sel[:, None], Xh[1], X[1]))
                rep = type(rep)(
                    iter=jnp.where(sel, reph.iter, rep.iter),
                    solution_error=jnp.where(sel, reph.solution_error,
                                             rep.solution_error))
        if not dense:
            return X[0], X[1], rep
        return X, rep

    def solve_on_device(self, y: jnp.ndarray, tolerance,
                        max_iterations: int = 100):
        """Jit-composable solve: device arrays in, (x, report pytree) out.

        Under precision="certified" the report's solution_error is the
        high-precision certificate, but no automatic re-solve happens
        here (a data-dependent re-solve cannot live under jit) — check
        ``solution_error <= tolerance`` downstream, or use ``solve``.
        """
        if self._mesh is not None:
            X, rep = self.solve_batch_on_device(y[None, :], tolerance,
                                                max_iterations)
            return X[0], type(rep)(iter=rep.iter[0],
                                   solution_error=rep.solution_error[0])
        return self._fn(max_iterations, batch=None)(
            self._A, self._G, y, tolerance)

    def solve_batch_on_device(self, Y: jnp.ndarray, tolerance,
                              max_iterations: int = 100,
                              dense: bool = True):
        """Jit-composable batched solve over device arrays.

        Y: (batch, m) device array; tolerance may be a traced scalar.
        Returns (X (batch, n), HomotopyReportArrays pytree) without any
        device→host transfer — composes under an outer ``jax.jit`` /
        ``shard_map`` (the serving-loop entry point; ``solve_batch``
        wraps this plus host-side conversion and engine routing).
        ``dense=False`` returns ((values, indices), report) — the
        compact slot-space solution (see ``solve_batch``).

        Under precision="certified" the per-lane solution_error is the
        fused high-precision certificate; the automatic re-solve of
        failing lanes lives only in ``solve_batch`` (data-dependent work
        cannot live under jit) — check ``solution_error <= tolerance``
        per lane downstream.

        With ``mesh=`` the solve routes through the sharded driver
        (Y must already be (batch_padded, m_padded) matching the placed
        A; certified raises under an outer jit — see homotopy_sharded).
        """
        if self._mesh is not None:
            from .parallel import sharding as _sh
            A, G = self._mesh_arrays()
            Y, bpad = _mesh_pad_jit(self._mesh, Y, A.shape[0])
            k_max = self._k_max or min(self._n, max_iterations + 1)
            out = _sh.homotopy_sharded(
                self._mesh, A, Y, tolerance, max_iterations, k_max=k_max,
                gram=self._gram_enabled if G is None else None, G=G,
                precision=self._precision, dense=dense)
            rep = out[-1]
            X = out[0] if dense else (out[0], out[1])
            X, rep = _trim_batch(X, rep, bpad, dense)
            return ((X[0], X[1]), rep) if not dense else (X, rep)
        return self._fn(max_iterations, batch=Y.shape[0], dense=dense)(
            self._A, self._G, Y, tolerance)

    def _tol(self, tolerance):
        return (_default_tolerance(self.dtype)
                if tolerance is None else float(tolerance))


class Irls:
    """IRLS solver over a fixed sensing matrix A (m×n, m ≥ n).

    The economy QR of A is computed once here and reused across every solve
    (the reference computes it in the solver constructor, src/lib.cpp:51-57).

    ``precision`` pins the matmul precision of the iteration
    ("highest" default — exact mode's Newton step runs O(mn²) gemms
    whose accuracy feeds the Cholesky SPD decision; fast mode's
    triangular solves are precision-insensitive, so lowering it mostly
    affects exact mode). IRLS has no "certified" variant: its reported
    solution_error is the reweighting schedule's eps (irls-cpu.cpp:123),
    not a residual, so there is no convergence criterion to certify.

    ``mesh=`` (jax.sharding.Mesh with ("data", "row") axes) makes this
    the construct-once sharded solver object: the economy QR is computed
    ONCE on the mesh itself by CholeskyQR2 (parallel.sharding.qr_sharded
    — no host factorization) and cached; solve/solve_batch route through
    ``parallel.sharding.irls_sharded`` with batch/row padding handled
    here.

    ``stabilized=True`` (beyond reference) normalizes each Newton
    iterate by its maximum before the threshold/eps/weight updates,
    removing the reference recurrence's intrinsic scale divergence —
    which otherwise drives min(w) through the Cholesky/pivot floor
    after ~4 iterations (f32) / ~8 (f64) on Gaussian ensembles at
    n ≥ 512, ending every sufficiently-hard solve in ``spd_failure``
    (docs/algorithms.md §2a). Support decisions per iteration are
    unchanged (the threshold selects by ratios); lanes run until the
    do-while's own criterion decides. Currently jax-engine only.
    """

    def __init__(self, A, engine: str = "auto", mode: str = "fast",
                 precision: str = "highest", stabilized: bool = False,
                 mesh=None):
        if engine not in ("auto", "jax", "native"):
            raise ValueError(
                f"engine must be 'auto', 'jax' or 'native', got {engine!r}")
        if mode not in ("fast", "exact"):
            raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
        if precision not in ("highest", "high", "default"):
            raise ValueError(
                "precision must be 'highest', 'high' or 'default' "
                f"(IRLS has no certified variant), got {precision!r}")
        if stabilized and engine == "native":
            raise ValueError(
                "stabilized IRLS runs on the jax engine (the native host "
                "backend implements the reference recurrence)")
        if mesh is not None:
            _check_mesh(mesh, engine)
        self._engine = engine
        self._precision = precision
        self._mode = mode
        self._stabilized = bool(stabilized)
        self._native = None
        self._A = ndview.as_matrix(A)
        self._m, self._n = self._A.shape
        if mesh is None:
            _warn_small_problem_jax(engine, self._m, self._n)
        if self._m < self._n:
            raise ValueError(
                "Irls requires m >= n (underdetermined systems not "
                f"supported); got {self._m}x{self._n}"
            )
        self._QR_cache = None
        self._Rinv_cache = None
        self._mesh = mesh
        self._QR_mesh = None  # (Q row-sharded, R replicated), lazy
        self._cache: dict = {}

    def _qr(self):
        # XLA's blocked QR is the fast path; see linalg/qr.py for the
        # explicit Householder component. The IRLS iteration is invariant
        # to the column-sign convention of the factorization. Computed
        # lazily so native-engine construction does no device work.
        if self._QR_cache is None:
            QR = jnp.linalg.qr(self._A, mode="reduced")
            if isinstance(QR[0], jax.core.Tracer):
                return QR  # traced under an outer jit: don't cache (see _G)
            self._QR_cache = QR
        return self._QR_cache

    @property
    def _Q(self):
        return self._qr()[0]

    @property
    def _R(self):
        return self._qr()[1]

    @property
    def _Rinv(self):
        """R⁻¹, cached on device for the opt-in gemm Newton step
        (SS_IRLS_GEMM=1): applying it is one (b,n)×(n,n) gemm per
        batched step. It measured level with the default batched
        back-substitution on the previous accelerator, so it is kept as
        an alternative formulation rather than the default (its GPU A/B
        is ROADMAP queue 1 #5).
        Computed once by triangular solve against I (exact algebra; fp
        trajectory differs in the last bits — parity pinned in
        tests/test_batch.py)."""
        if self._Rinv_cache is None:
            R = self._R
            eye = jnp.eye(self._n, dtype=R.dtype)
            Rinv = jax.jit(_blas.xtrsm, static_argnames="lower")(
                R, eye, lower=False)
            if isinstance(Rinv, jax.core.Tracer):
                return Rinv  # traced under an outer jit: never cache
            self._Rinv_cache = Rinv
        return self._Rinv_cache

    def _mesh_qr(self):
        """Construct-once mesh factorization: CholeskyQR2 on the mesh
        itself (parallel.sharding.qr_sharded — Gram psum → replicated
        Cholesky → local gemms; no host factorization anywhere), cached
        per instance. The reference's QR-at-construction amortization
        (src/lib.cpp:51-57) at mesh scale."""
        if self._QR_mesh is None:
            from .parallel import sharding as _sh
            self._QR_mesh = _sh.qr_sharded(self._mesh,
                                           jnp.asarray(self._A))
        return self._QR_mesh

    def _solve_batch_mesh(self, Y, tol, max_iterations: int):
        from .parallel import sharding as _sh
        Q, R = self._mesh_qr()
        Yd, bpad = _mesh_prep_batch(self._mesh, Y, Q.shape[0])
        X, rep = _sh.irls_sharded(
            self._mesh, Q, R, Yd, tol, max_iterations, mode=self._mode,
            newton="gemm" if self._newton_gemm(batched=True) else "trsm",
            stabilized=self._stabilized)
        return _trim_batch(X, rep, bpad, dense=True)

    def _newton_gemm(self, batched: bool) -> bool:
        """Whether the batched fast path applies the cached R⁻¹ by gemm
        (SS_IRLS_GEMM=1 opt-in). The default stays on the batched
        back-substitution, whose fp trajectory matches single solves
        exactly; gemm and trsm measured level on the previous
        accelerator and await a GPU A/B (ROADMAP queue 1 #5)."""
        if not batched or self._mode != "fast":
            return False
        return os.environ.get("SS_IRLS_GEMM") == "1"

    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self):
        return self._A.dtype

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan report (see Homotopy.explain)."""
        if self._use_native(probe=True):
            return {"engine": "native", "mode": self._mode,
                    "backend": "csrc host (C++)"}
        if self._mesh is not None:
            plan = {"engine": "jax", "backend": jax.default_backend(),
                    "mode": self._mode, "mesh": dict(self._mesh.shape),
                    "sharded": True,
                    "formulation": ("row+data shard_map IRLS "
                                    "(parallel/sharding.irls_sharded; "
                                    "construction QR = mesh-native "
                                    "CholeskyQR2)"),
                    "qr_cached": self._QR_mesh is not None}
            if self._stabilized:
                plan["stabilized"] = True
            return plan
        plan = {"engine": "jax", "backend": jax.default_backend(),
                "mode": self._mode,
                "formulation": ("vmapped IRLS iteration" if batch is not None
                                else "IRLS iteration"),
                "qr_cached": self._QR_cache is not None}
        if self._newton_gemm(batched=batch is not None):
            plan["newton"] = "gemm(R^-1), cached inverse"
        if self._stabilized:
            plan["stabilized"] = True
        return plan

    def _fn(self, max_iterations: int, batched: bool):
        _check_max_iterations(max_iterations)
        gemm = self._newton_gemm(batched)
        key = (max_iterations, batched, gemm, self._stabilized)
        fn = self._cache.get(key)
        if fn is None:
            def core(Q, R, y, tol, r_inv=None):
                with _blas.precision_scope(self._precision):
                    return _irls.solve_irls(Q, R, y, tol,
                                            max_iterations=max_iterations,
                                            mode=self._mode, r_inv=r_inv,
                                            stabilized=self._stabilized)
            if batched:
                run = jax.vmap(core, in_axes=(None, None, 0, None, None))
            else:
                run = core
            jfn = jax.jit(run)
            if gemm:
                fn = lambda Q, R, y, tol: jfn(Q, R, y, tol, self._Rinv)
            else:
                fn = lambda Q, R, y, tol: jfn(Q, R, y, tol, None)
            self._cache[key] = fn
        return fn

    def _use_native(self, probe: bool = False) -> bool:
        # stabilized mode exists only in the jax engine (ctor rejects an
        # explicit engine="native"; auto routing skips it here)
        if (self._engine == "jax" or self._stabilized
                or self._mesh is not None):
            return False
        return _route_native(self._engine, self._m, self._n, probe)

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Solve min‖x‖₁ s.t. Ax = b; returns (x, IrlsReport)."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._mesh is not None:
            X, rep = self._solve_batch_mesh(y[None, :], tol,
                                            max_iterations)
            x, it, err, spd = jax.device_get(
                (X[0], rep.iter[0], rep.solution_error[0],
                 rep.spd_failure[0]))
            return x, IrlsReport(iter=int(it), solution_error=float(err),
                                 spd_failure=bool(spd))
        if self._use_native():
            from .backend import native as _native
            if self._native is None:
                self._native = _native.IrlsNative(np.asarray(self._A))
            xn, it, err, spd = self._native.solve(np.asarray(y), tol,
                                                  max_iterations)
            return xn, IrlsReport(iter=it, solution_error=err,
                                  spd_failure=spd)
        x, rep = self._fn(max_iterations, batched=False)(
            self._Q, self._R, y, tol)
        # one fused device→host transfer (see Homotopy.solve)
        x, it, err, spd = jax.device_get(
            (x, rep.iter, rep.solution_error, rep.spd_failure))
        return x, IrlsReport(iter=int(it), solution_error=float(err),
                             spd_failure=bool(spd))

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100):
        """Batched solve over signals B of shape (batch, m)."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._mesh is not None:
            return self._solve_batch_mesh(Y, tol, max_iterations)
        if self._use_native():
            # threaded C++ batch over the cached QR handle; one worker
            # workspace per thread running the identical single-solve
            # iteration keeps batch ≡ sequential bit-identical
            from .backend import native as _native
            if self._native is None:
                self._native = _native.IrlsNative(np.asarray(self._A))
            Yn = np.asarray(Y)
            if Yn.shape[0] == 0:  # nothing to solve; keep shapes honest
                return (np.zeros((0, self._n), self.dtype),
                        _irls.IrlsReportArrays(
                            iter=np.zeros(0, np.uint32),
                            solution_error=np.zeros(0, self.dtype),
                            spd_failure=np.zeros(0, bool)))
            X, its, errs, spds = self._native.solve_batch(Yn, tol,
                                                          max_iterations)
            return X, _irls.IrlsReportArrays(
                iter=its.astype(np.uint32),
                solution_error=errs.astype(self.dtype),
                spd_failure=spds)
        return self._fn(max_iterations, batched=True)(
            self._Q, self._R, Y, tol)

    def solve_on_device(self, y: jnp.ndarray, tolerance,
                        max_iterations: int = 100):
        """Jit-composable solve: device arrays in, (x, report pytree) out."""
        if self._mesh is not None:
            X, rep = self.solve_batch_on_device(y[None, :], tolerance,
                                                max_iterations)
            return X[0], type(rep)(
                iter=rep.iter[0], solution_error=rep.solution_error[0],
                spd_failure=rep.spd_failure[0])
        return self._fn(max_iterations, batched=False)(
            self._Q, self._R, y, tolerance)

    def solve_batch_on_device(self, Y: jnp.ndarray, tolerance,
                              max_iterations: int = 100):
        """Jit-composable batched solve (see Homotopy.solve_batch_on_device).
        With ``mesh=``, Y must already match the placed Q's padded row
        count (use ``solve_batch`` for host-side padding/trimming)."""
        if self._mesh is not None:
            from .parallel import sharding as _sh
            Q, R = self._mesh_qr()
            Y, bpad = _mesh_pad_jit(self._mesh, Y, Q.shape[0])
            X, rep = _sh.irls_sharded(
                self._mesh, Q, R, Y, tolerance, max_iterations,
                mode=self._mode,
                newton="gemm" if self._newton_gemm(batched=True)
                else "trsm",
                stabilized=self._stabilized)
            return _trim_batch(X, rep, bpad, dense=True)
        return self._fn(max_iterations, batched=True)(
            self._Q, self._R, Y, tolerance)

    def _tol(self, tolerance):
        return (_default_tolerance(self.dtype)
                if tolerance is None else float(tolerance))


class IrlsCg:
    """CG-accelerated IRLS for the underdetermined regime (m ≤ n).

    Beyond-reference capability: the reference's IRLS rejects m < n
    ("underdetermined systems not supported", irls_test.cpp:53) because
    its Newton step needs the QR of a tall A. This solver runs the
    classical Daubechies–DeVore–Fornasier–Güntürk IRLS with a conjugate-
    gradient inner solve (arXiv:1509.04063) — factorization-free, so it
    also serves problems too large to QR (construction does no device
    work at all; each solve touches A only through matvec/rmatvec
    gemvs). For distributed problems see
    ``parallel.sharding.irls_cg_sharded`` (one psum per CG step).

    Parameters
    ----------
    A : (m, n) array-like, float32 or float64, m ≤ n.
    p : reweighting exponent in (0, 1]; 1.0 (default) is convex ℓ₁
        basis pursuit; p < 1 matches the reference IRLS's non-convex
        flavor (irls-cpu.cpp:70 uses 0.9).
    k_sparsity : the K of the ε-rule ε ← min(ε, r_{K+1}(x)/n); any K at
        or above the true sparsity preserves recovery. Default m // 4.
    cg_max_iterations / cg_tolerance : inner CG budget and relative
        residual target (default: tolerance/10, clamped to
        [10·machine-eps, √machine-eps] — the inner accuracy sets the
        floor of the outer convergence test).
    precision : matmul precision ("highest" default).
    engine : "jax", "native" (C++ host backend, csrc/), or "auto"
        (default) — like the other solvers, problems below the device
        dispatch-latency floor route to the host engine, which runs the
        identical iteration in exact FMA arithmetic.

    Reports carry the reference IRLS field names (iter, solution_error =
    final ε, spd_failure = inner-CG curvature breakdown — the analog of
    the reference's Cholesky pivot failure, irls-cpu.cpp:50-51).
    """

    def __init__(self, A, p: float = 1.0, k_sparsity: int | None = None,
                 cg_max_iterations: int | None = None,
                 cg_tolerance: float | None = None,
                 precision: str = "highest", engine: str = "auto",
                 mesh=None):
        if precision not in ("highest", "high", "default"):
            raise ValueError(
                "precision must be 'highest', 'high' or 'default', "
                f"got {precision!r}")
        if engine not in ("auto", "jax", "native"):
            raise ValueError(
                f"engine must be 'auto', 'jax' or 'native', got {engine!r}")
        if not (0 < p <= 1.0):
            raise ValueError(f"p must be in (0, 1], got {p}")
        if k_sparsity is not None and k_sparsity < 1:
            raise ValueError(f"k_sparsity must be >= 1, got {k_sparsity}")
        if cg_max_iterations is not None and cg_max_iterations < 1:
            raise ValueError(
                f"cg_max_iterations must be >= 1, got {cg_max_iterations}")
        if cg_tolerance is not None and not cg_tolerance > 0:
            raise ValueError(
                f"cg_tolerance must be > 0, got {cg_tolerance}")
        self._A = ndview.as_matrix(A)
        self._m, self._n = self._A.shape
        if self._m > self._n:
            raise ValueError(
                "IrlsCg serves the underdetermined regime (m <= n); for "
                f"m > n use Irls (got {self._m}x{self._n})")
        self._p = p
        self._k = k_sparsity
        self._cg_max = cg_max_iterations
        self._cg_tol = cg_tolerance
        self._precision = precision
        self._engine = engine
        if mesh is not None:
            _check_mesh(mesh, engine)
        else:
            _warn_small_problem_jax(engine, self._m, self._n)
        self._mesh = mesh
        self._A_mesh = None  # lazy column-sharded placement
        self._cache: dict = {}

    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self):
        return self._A.dtype

    def update_column(self, j: int, col) -> None:
        """Replace column j of the sensing matrix in place (gallery
        churn, see Homotopy.update_column). CG-IRLS is factorization-
        free, so nothing else needs updating."""
        if not (0 <= j < self._n):
            raise ValueError(f"column index {j} out of range [0, {self._n})")
        v = jnp.asarray(ndview.as_vector(col, dtype=self.dtype,
                                         size=self._m))
        fn = self._cache.get(("colupd",))
        if fn is None:
            fn = jax.jit(lambda A, v, j: A.at[:, j].set(v))
            self._cache[("colupd",)] = fn
        self._A = fn(jnp.asarray(self._A), v, j)
        self._A_mesh = None  # mesh placement is stale

    def _use_native(self, probe: bool = False) -> bool:
        if self._engine == "jax" or self._mesh is not None:
            return False
        return _route_native(self._engine, self._m, self._n, probe)

    def _mesh_a(self):
        """Construct-once column-sharded placement (the n axis is the
        large dimension in the basis-pursuit regime; columns padded to
        the mesh multiple — zero columns are inert,
        parallel.sharding.irls_cg_sharded)."""
        if self._A_mesh is None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from .parallel import sharding as _sh
            n_dev = self._mesh.shape[_sh.ROW_AXIS]
            pad = (-self._n) % n_dev
            A = jnp.asarray(self._A)
            if pad:
                A = jnp.pad(A, ((0, 0), (0, pad)))
            self._A_mesh = jax.device_put(
                A, NamedSharding(self._mesh, P(None, _sh.ROW_AXIS)))
        return self._A_mesh

    def _solve_batch_mesh(self, Y, tol, max_iterations: int):
        from jax.sharding import NamedSharding, PartitionSpec as P
        from .parallel import sharding as _sh
        A = self._mesh_a()
        Y = jnp.asarray(Y)
        bpad = (-Y.shape[0]) % self._mesh.shape[_sh.DATA_AXIS]
        if bpad:
            Y = jnp.pad(Y, ((0, bpad), (0, 0)))
        Y = jax.device_put(
            Y, NamedSharding(self._mesh, P(_sh.DATA_AXIS, None)))
        X, rep = _sh.irls_cg_sharded(
            self._mesh, A, Y, tol, max_iterations, p=self._p,
            k_sparsity=self._k, cg_max_iterations=self._cg_max,
            cg_tolerance=self._cg_tol)
        X = X[:, :self._n]
        return _trim_batch(X, rep, bpad, dense=True)

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan report (see Homotopy.explain)."""
        if self._use_native(probe=True):
            return {"engine": "native", "mode": "cg",
                    "backend": "csrc host (C++)",
                    "factorization_free": True}
        if self._mesh is not None:
            return {"engine": "jax", "backend": jax.default_backend(),
                    "mode": "cg", "precision": self._precision,
                    "p": self._p, "mesh": dict(self._mesh.shape),
                    "sharded": True,
                    "formulation": ("column+data shard_map CG-IRLS "
                                    "(parallel/sharding."
                                    "irls_cg_sharded)")}
        return {"engine": "jax", "backend": jax.default_backend(),
                "mode": "cg", "precision": self._precision,
                "p": self._p,
                "formulation": ("vmapped CG-IRLS iteration"
                                if batch is not None
                                else "CG-IRLS iteration"),
                "factorization_free": True}

    def _fn(self, max_iterations: int, batched: bool):
        _check_max_iterations(max_iterations)
        from .solvers import irls_cg as _irls_cg
        key = (max_iterations, batched)
        fn = self._cache.get(key)
        if fn is None:
            def core(A, y, tol):
                with _blas.precision_scope(self._precision):
                    return _irls_cg.solve_irls_cg(
                        A, y, tol, max_iterations, p=self._p,
                        k_sparsity=self._k,
                        cg_max_iterations=self._cg_max,
                        cg_tolerance=self._cg_tol)
            run = core
            if batched:
                run = jax.vmap(core, in_axes=(None, 0, None))
            fn = jax.jit(run)
            self._cache[key] = fn
        return fn

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Solve min‖x‖₁ s.t. Ax = b; returns (x, IrlsReport)."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._use_native():
            from .backend import native as _native
            xn, it, eps, broke = _native.irls_cg_solve(
                np.asarray(self._A), np.asarray(y), tol, max_iterations,
                p=self._p, k_sparsity=self._k,
                cg_max_iterations=self._cg_max, cg_tolerance=self._cg_tol)
            return xn, IrlsReport(iter=it, solution_error=eps,
                                  spd_failure=broke)
        if self._mesh is not None:
            X, rep = self._solve_batch_mesh(y[None, :], tol,
                                            max_iterations)
            x, it, err, spd = jax.device_get(
                (X[0], rep.iter[0], rep.solution_error[0],
                 rep.spd_failure[0]))
            return x, IrlsReport(iter=int(it), solution_error=float(err),
                                 spd_failure=bool(spd))
        x, rep = self._fn(max_iterations, batched=False)(self._A, y, tol)
        x, it, err, spd = jax.device_get(
            (x, rep.iter, rep.solution_error, rep.spd_failure))
        return x, IrlsReport(iter=int(it), solution_error=float(err),
                             spd_failure=bool(spd))

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100):
        """Batched solve over signals B of shape (batch, m)."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._mesh is not None:
            return self._solve_batch_mesh(Y, tol, max_iterations)
        if self._use_native():
            from .backend import native as _native
            # one device→host transfer each for the whole batch (reads
            # of device arrays are blocking round trips); the batch runs across the host thread pool
            # with results bit-equal to per-signal solves
            X, its, errs, spds = _native.irls_cg_solve_batch(
                np.asarray(self._A), np.asarray(Y), tol, max_iterations,
                p=self._p, k_sparsity=self._k,
                cg_max_iterations=self._cg_max,
                cg_tolerance=self._cg_tol)
            return X, _irls.IrlsReportArrays(
                iter=its.astype(np.uint32),
                solution_error=errs.astype(self.dtype),
                spd_failure=spds)
        return self._fn(max_iterations, batched=True)(self._A, Y, tol)

    def solve_on_device(self, y: jnp.ndarray, tolerance,
                        max_iterations: int = 100):
        """Jit-composable solve: device arrays in, (x, report pytree) out."""
        if self._mesh is not None:
            X, rep = self.solve_batch_on_device(y[None, :], tolerance,
                                                max_iterations)
            return X[0], type(rep)(
                iter=rep.iter[0], solution_error=rep.solution_error[0],
                spd_failure=rep.spd_failure[0])
        return self._fn(max_iterations, batched=False)(self._A, y, tolerance)

    def solve_batch_on_device(self, Y: jnp.ndarray, tolerance,
                              max_iterations: int = 100):
        """Jit-composable batched solve over device arrays."""
        if self._mesh is not None:
            from .parallel import sharding as _sh
            bpad = (-Y.shape[0]) % self._mesh.shape[_sh.DATA_AXIS]
            if bpad:
                Y = jnp.pad(Y, ((0, bpad), (0, 0)))
            X, rep = _sh.irls_cg_sharded(
                self._mesh, self._mesh_a(), Y, tolerance, max_iterations,
                p=self._p, k_sparsity=self._k,
                cg_max_iterations=self._cg_max,
                cg_tolerance=self._cg_tol)
            return _trim_batch(X[:, :self._n], rep, bpad, dense=True)
        return self._fn(max_iterations, batched=True)(self._A, Y, tolerance)

    def _tol(self, tolerance):
        return (_default_tolerance(self.dtype)
                if tolerance is None else float(tolerance))


class Omp:
    """Orthogonal Matching Pursuit over a fixed sensing matrix A (m×n).

    Beyond-reference solver family (the reference ships homotopy + IRLS
    only): the standard greedy pursuit — grow the support by the column
    most correlated with the residual, re-solve least squares on it,
    stop at ``‖y − Ax‖₂ ≤ tolerance`` or after ``max_iterations``
    column picks (solvers/omp.py). Shares the framework's construct-
    once machinery: the Gram matrix is computed lazily once and reused,
    executables are cached per (max_iterations, k_max, batch-ness), and
    batching is one vmapped program over signals sharing A.

    Parameters mirror ``Homotopy`` where they apply: ``k_max`` caps the
    support (default min(n, m, max_iterations) — OMP only inserts, so
    this never overflows), ``mode`` "fast"/"exact", ``precision`` matmul
    precision (default "certified" in fast mode / "highest" in exact;
    "certified" runs the pick loop at one-pass precision and reports a
    fused parity-grade residual certificate ‖y−Ax‖₂ per lane, with
    solve/solve_batch re-solving certificate-failing lanes at
    blas.PARITY — homotopy's certified design on the ℓ₂ criterion),
    ``engine`` "jax"/"native"/"auto".

    ``gram``: None (default) precomputes AᵀA when n² fits in 1 GiB and
    lets the measured batch·k_max < 2m crossover choose the
    correlation-update formulation per call (Gram-column gathers vs one
    amortized pass over A — the per-pick insert uses the Gram
    either way); True additionally pins the Gram-gather formulation;
    False disables the Gram entirely. In ``mode="exact"`` the Gram is
    never used (``gram=True`` raises): the cached AᵀA is computed at
    the fast path's precision, so exact mode recomputes every Gram
    entry per pick at HIGHEST precision to keep its bit-faithful
    fp-trajectory contract.

    ``mesh``: like ``Homotopy`` with ``mesh=`` — A placed row-sharded
    once, the replicated Gram psum'd once per mesh, solve/solve_batch
    routed through ``parallel.sharding.omp_sharded``.

    ``picks`` (≥ 1, default 1): generalized OMP — each round inserts
    the ``picks`` largest inactive correlations and runs one LS
    re-solve and one correlation update, amortizing the per-round full
    pass over A across ``picks`` support additions (~k/picks passes
    for a k-sparse recovery; may overshoot the minimal support by up
    to picks−1 near-zero coefficients near the tolerance —
    solvers/omp.py). Runs on every route: the slot-space batch driver
    (one q pass per round — the driver's dominant cost amortized
    J-fold, solvers/omp_batch.py), the vmapped core, and the native
    host twin (ss_omp_solve_pk entry points).
    """

    def __init__(self, A, k_max: int | None = None, mode: str = "fast",
                 gram: bool | None = None, precision: str | None = None,
                 engine: str = "auto", mesh=None, picks: int = 1):
        if mode not in ("fast", "exact"):
            raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
        if engine not in ("auto", "jax", "native"):
            raise ValueError(
                f"engine must be 'auto', 'jax' or 'native', got {engine!r}")
        if engine == "native" and mode == "exact":
            raise ValueError(
                "engine='native' implements the fast-path algorithm; "
                "mode='exact' requires the jax engine")
        if not isinstance(picks, int) or picks < 1:
            raise ValueError(f"picks must be an int >= 1, got {picks!r}")
        if mesh is not None:
            if mode == "exact":
                raise ValueError(
                    "mesh-sharded solving runs the fast-path "
                    "formulation; mode='exact' is single-device")
            _check_mesh(mesh, engine)
        if precision is not None and precision not in _PRECISION_VALUES:
            raise ValueError(
                "precision must be 'highest', 'high', 'default' or "
                f"'certified', got {precision!r}")
        if precision == "certified" and mode == "exact":
            raise ValueError(
                "precision='certified' runs the pick loop at one-pass "
                "precision with a parity-grade residual "
                "certificate — exact mode wants the full-precision "
                "trajectory; use precision='highest'")
        if gram is True and mode == "exact":
            raise ValueError(
                "gram=True pins the precomputed-Gram formulation, but "
                "mode='exact' never reads the cached AᵀA (it is built "
                "at fast-path precision; exact mode recomputes "
                "Gram entries per pick at HIGHEST precision to keep the "
                "bit-faithful trajectory contract) — drop gram=True or "
                "use mode='fast'")
        if k_max is not None and k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        self._engine = engine
        self._A = ndview.as_matrix(A)
        self._m, self._n = self._A.shape
        if picks > self._n:
            raise ValueError(
                f"picks must be <= n = {self._n} (each round selects "
                f"picks inactive columns), got {picks}")
        if mesh is None:
            _warn_small_problem_jax(engine, self._m, self._n)
        self._k_max = k_max
        self._mode = mode
        # Homotopy's convention: certified one-pass + fused parity-grade
        # residual certificate on the fast path (failing lanes
        # re-solved); HIGHEST in exact mode.
        self._precision = precision or ("certified" if mode == "fast"
                                        else "highest")
        self._gram_forced = gram is True  # explicit True pins the
        # Gram-gather correlation formulation (auto only routes it)
        if gram is None:
            gram = (self._n * self._n * self._A.dtype.itemsize
                    <= _GRAM_AUTO_BYTES)
        self._gram_enabled = bool(gram and mode == "fast")
        self._G_cache = None
        self._mesh = mesh
        self._picks = picks
        self._A_mesh = self._G_mesh = None  # lazy sharded placements
        self._cache: dict = {}

    @property
    def _G(self):
        return _lazy_gram(self)

    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self):
        return self._A.dtype

    def update_column(self, j: int, col) -> None:
        """Replace column j in place (gallery churn — see
        Homotopy.update_column; the cached Gram row/col is rewritten
        incrementally)."""
        _update_column_impl(self, j, col)

    def _use_native(self, probe: bool = False) -> bool:
        if (self._engine == "jax" or self._mode == "exact"
                or self._mesh is not None):
            return False
        return _route_native(self._engine, self._m, self._n, probe)

    def _mesh_arrays(self):
        """Construct-once sharded state (see Homotopy._mesh_arrays)."""
        if self._A_mesh is None:
            from .parallel import sharding as _sh
            self._A_mesh = _mesh_place_rows(self._mesh, self._A)
            if self._gram_enabled:
                self._G_mesh = _sh.gram_replicated(self._mesh,
                                                   self._A_mesh)
        return self._A_mesh, self._G_mesh

    def _mesh_gram_arg(self):
        """gram flag for omp_sharded: explicit True pins the Gram-gather
        formulation; auto-enabled passes None (the precomputed G flips
        it on without pinning); disabled is False."""
        if self._gram_forced:
            return True
        return None if self._gram_enabled else False

    def _solve_batch_mesh(self, Y, tol, max_iterations: int,
                          dense: bool = True):
        from .parallel import sharding as _sh
        A, G = self._mesh_arrays()
        Yd, bpad = _mesh_prep_batch(self._mesh, Y, A.shape[0])
        out = _sh.omp_sharded(
            self._mesh, A, Yd, tol, max_iterations,
            k_max=self._resolved_k_max(max_iterations),
            gram=self._mesh_gram_arg(), G=G,
            precision=self._precision, dense=dense, picks=self._picks)
        rep = out[-1]
        X = out[0] if dense else (out[0], out[1])
        X, rep = _trim_batch(X, rep, bpad, dense)
        if not dense:
            return X[0], X[1], rep
        return X, rep

    def _resolved_k_max(self, max_iterations: int) -> int:
        if self._k_max is not None:
            return min(self._k_max, self._n, self._m)
        return max(1, min(max_iterations, self._m, self._n))

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan report (see Homotopy.explain)."""
        if self._use_native(probe=True):
            return {"engine": "native", "mode": self._mode,
                    "backend": "csrc host (C++)",
                    "k_max": self._resolved_k_max(max_iterations)}
        if self._mesh is not None:
            from .parallel import sharding as _sh
            from .solvers.homotopy_batch import route_batch_native
            S = self._mesh.shape[_sh.ROW_AXIS]
            k_max = self._resolved_k_max(max_iterations)
            local_b = -(-(batch or 1) // self._mesh.shape[_sh.DATA_AXIS])
            m_pad = self._m + ((-self._m) % S)
            bn = ((not self._gram_forced) and route_batch_native(
                local_b, self._A.dtype,
                sparse=local_b * k_max < 2 * m_pad))
            plan = {"engine": "jax", "backend": jax.default_backend(),
                    "mode": self._mode, "precision": self._precision,
                    "mesh": dict(self._mesh.shape), "sharded": True,
                    "gram": self._gram_enabled,
                    "gram_cached": self._G_mesh is not None,
                    "k_max": k_max, "batch_native": bn,
                    "overlap_mode": ("ppermute"
                                     if bn and S > 1 and self._n >= 128 * S
                                     else "psum"),
                    "formulation": ("row+data shard_map OMP "
                                    "(parallel/sharding.omp_sharded)")}
            if self._picks > 1:
                plan["picks"] = self._picks
            if self._precision == "certified":
                plan["certificate"] = ("psum'd ‖y−Ax‖₂ at highest "
                                       "precision; failing lanes "
                                       "re-solve")
            return plan
        if self._route_driver(batch, max_iterations):
            plan = {"engine": "jax", "backend": jax.default_backend(),
                    "mode": self._mode, "precision": self._precision,
                    "corr": "driver",
                    "gram_free": not self._gram_enabled,
                    "k_max": self._resolved_k_max(max_iterations),
                    "formulation": "slot-space OMP batch driver "
                                   "(q product + in-place insert/LS"
                                   + (", gram-free)"
                                      if not self._gram_enabled else ")")}
        else:
            corr = self._route_corr(batch, max_iterations)
            plan = {"engine": "jax", "backend": jax.default_backend(),
                    "mode": self._mode, "precision": self._precision,
                    "corr": corr,
                    "k_max": self._resolved_k_max(max_iterations),
                    "formulation": ("vmapped OMP loop"
                                    if batch is not None
                                    else "OMP loop") + f" (corr={corr})"}
        if self._picks > 1:
            plan["picks"] = self._picks  # generalized OMP rounds
        if self._precision == "certified":
            plan["path_precision"] = "default"
            plan["certificate"] = ("‖y−Ax‖₂ at highest precision; "
                                   "solve/solve_batch re-solve lanes "
                                   "that miss the tolerance")
        return plan

    def _route_corr(self, batch: int | None, max_iterations: int) -> str:
        """Correlation-formulation routing (solve_omp_core ``corr``):
        Gram-column gathers cost O(n·k) bytes per lane-iteration, the
        dense two-gemm form one pass over A amortized across the
        batch — the same crossover rule as the homotopy cores'
        ``sparse`` heuristic (batch·k_max < 2m). Past the crossover,
        "dense" avoids the per-lane column-gather "sparse" form's
        (batch·k, m) gather tensor; "sparse" remains the single/low-
        batch choice when no Gram is held."""
        b = batch or 1
        small = b * self._resolved_k_max(max_iterations) < 2 * self._m
        if self._gram_enabled and (self._gram_forced or small):
            return "gram"
        return "sparse" if small else "dense"

    def _route_driver(self, batch: int | None,
                      max_iterations: int = 100) -> bool:
        """Batch-native driver routing: the slot-space driver
        (solvers/omp_batch.py — the shared q product + in-place
        insert/LS; gram-free when no Gram is held) serves batched f32
        fast-mode solves; the homotopy driver's shared rule decides (same env overrides: SS_BATCH_NATIVE=1 forces
        where structurally valid, =0 forbids). The ``sparse`` leg keeps
        the zero-full-pass-per-pick Gram-gather vmapped core for small
        batch·k_max (the driver pays a full q pass per pick)."""
        if batch is None or self._mode != "fast" or self._gram_forced:
            # gram=True pins the Gram-gather vmapped formulation (the
            # documented contract); the driver must not override it
            return False
        from .solvers.homotopy_batch import route_batch_native
        small = (batch * self._resolved_k_max(max_iterations)
                 < 2 * self._m)
        return route_batch_native(batch, self._A.dtype, sparse=small)

    def _fn(self, max_iterations: int, batched: bool,
            corr: str | None = None, driver: bool = False,
            dense: bool = True, precision: str | None = None):
        """Compiled solve program. ``precision`` overrides the instance
        setting (used by the certified re-solve path)."""
        _check_max_iterations(max_iterations)
        from .solvers import omp as _omp
        k_max = self._resolved_k_max(max_iterations)
        if corr is None:
            corr = "gram" if self._gram_enabled else "sparse"
        precision = precision or self._precision
        certified = precision == "certified"
        # certified: the pick loop runs at one-pass precision and the
        # reported error is a fused high-precision residual certificate
        # (homotopy's design, docs/design.md §3, on the ℓ₂ criterion).
        # The batch driver computes the certificate unconditionally; the
        # vmapped core gets the wrapper below.
        path_precision = path_precision_of(precision)
        key = ("omp", max_iterations, k_max, batched, corr, driver,
               dense, precision, self._picks)
        fn = self._cache.get(key)
        if fn is None:
            if driver:
                from .solvers import omp_batch as _omp_batch

                def run(A, G, Y, tol):
                    with _blas.precision_scope(path_precision):
                        return _omp_batch.solve_omp_batch(
                            A, G, Y, tol, max_iterations, k_max,
                            dense=dense, picks=self._picks)
            else:
                def core(A, G, y, tol):
                    # G rides along for the O(k) per-pick inserts
                    # whenever it exists; corr selects only the
                    # correlation formulation (review finding: dropping
                    # G wholesale made every pick pay a full AᵀA e_j
                    # pass)
                    op = _operators.DenseOperator(A, G)
                    with _blas.precision_scope(path_precision):
                        return _omp.solve_omp_core(
                            op, self._n, y, tol, max_iterations, k_max,
                            mode=self._mode, corr=corr,
                            picks=self._picks)
                base = core
                if batched:
                    base = jax.vmap(core, in_axes=(None, None, 0, None))

                def run(A, G, Y, tol):
                    X, rep = base(A, G, Y, tol)
                    if certified:
                        err = _certified_l2_error(A, X, Y)
                        rep = rep._replace(solution_error=err.astype(
                            rep.solution_error.dtype))
                    if batched and not dense:
                        return _compact_from_dense_jax(X, k_max), rep
                    return X, rep
            fn = jax.jit(run)
            self._cache[key] = fn
        return fn

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Greedy-solve y ≈ Ax with ≤ max_iterations support picks;
        returns (x, OmpReport)."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        if self._mesh is not None:
            X, rep = self._solve_batch_mesh(y[None, :], tol,
                                            max_iterations)
            x, it, err = jax.device_get(
                (X[0], rep.iter[0], rep.solution_error[0]))
            return x, OmpReport(iter=int(it), solution_error=float(err))
        if self._use_native():
            from .backend import native as _native
            xn, it, err = _native.omp_solve(
                np.asarray(self._A), np.asarray(y), tol, max_iterations,
                self._resolved_k_max(max_iterations), picks=self._picks)
            return xn, OmpReport(iter=it, solution_error=err)
        corr = self._route_corr(None, max_iterations)
        x, rep = self._fn(max_iterations, batched=False, corr=corr)(
            self._A, self._G, y, tol)
        x, it, err = jax.device_get((x, rep.iter, rep.solution_error))
        if (self._precision == "certified" and not (err <= tol)
                and int(it) < max_iterations):
            # the certificate caught a one-pass miss: re-solve at
            # blas.PARITY (certified's guarantee; mirrors Homotopy.solve)
            x2, rep2 = self._fn(max_iterations, batched=False, corr=corr,
                                precision=_blas.PARITY)(self._A, self._G,
                                                        y, tol)
            x, it, err = jax.device_get(
                (x2, rep2.iter, rep2.solution_error))
        return x, OmpReport(iter=int(it), solution_error=float(err))

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100, dense: bool = True):
        """Batched greedy solve over signals B of shape (batch, m).

        ``dense=False`` returns ``(values, indices, report)`` — the
        compact slot-space solution (values (batch, k_max) at columns
        indices (batch, k_max), sentinel n = empty slot), skipping the
        (batch, n) scatter and its dense device→host transfer on the
        batch-driver route (see ``Homotopy.solve_batch``);
        ``densify_batch(values, indices, n)`` reconstructs X exactly."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        k_max = self._resolved_k_max(max_iterations)
        if self._mesh is not None:
            return self._solve_batch_mesh(Y, tol, max_iterations, dense)
        if self._use_native():
            from .backend import native as _native
            X, its, errs = _native.omp_solve_batch(
                np.asarray(self._A), np.asarray(Y), tol, max_iterations,
                k_max, picks=self._picks)
            from .solvers import omp as _omp
            rep = _omp.OmpReportArrays(
                iter=its.astype(np.uint32), solution_error=errs)
            if not dense:
                vals, idxs = _compact_from_dense(X, k_max)
                return vals, idxs, rep
            return X, rep
        driver = self._route_driver(Y.shape[0], max_iterations)
        corr = (None if driver
                else self._route_corr(Y.shape[0], max_iterations))
        out, rep = self._fn(max_iterations, batched=True, corr=corr,
                            driver=driver, dense=dense)(
            self._A, self._G, Y, tol)
        if self._precision == "certified":
            # lanes whose parity-grade certificate misses the
            # tolerance re-solve at blas.PARITY — one shape-stable full-batch
            # re-solve, merged per lane (Homotopy.solve_batch's design;
            # lanes that exhausted max_iterations are honestly
            # non-convergent and excluded)
            errs = np.asarray(rep.solution_error)
            bad = (~(errs <= tol)) & (
                np.asarray(rep.iter) < max_iterations)
            if bad.any():
                outh, reph = self._fn(max_iterations, batched=True,
                                      corr=corr, driver=driver,
                                      dense=dense,
                                      precision=_blas.PARITY)(
                    self._A, self._G, Y, tol)
                sel = jnp.asarray(bad)
                if dense:
                    out = jnp.where(sel[:, None], outh, out)
                else:
                    out = (jnp.where(sel[:, None], outh[0], out[0]),
                           jnp.where(sel[:, None], outh[1], out[1]))
                rep = type(rep)(
                    iter=jnp.where(sel, reph.iter, rep.iter),
                    solution_error=jnp.where(sel, reph.solution_error,
                                             rep.solution_error))
        if not dense:
            return out[0], out[1], rep
        return out, rep

    def solve_on_device(self, y: jnp.ndarray, tolerance,
                        max_iterations: int = 100):
        """Jit-composable solve: device arrays in, (x, report pytree)
        out. Under precision="certified" the report carries the
        high-precision residual certificate but no automatic re-solve
        happens here (data-dependent work cannot live under jit —
        ``solve`` has it); check ``solution_error <= tolerance``
        downstream."""
        if self._mesh is not None:
            X, rep = self.solve_batch_on_device(y[None, :], tolerance,
                                                max_iterations)
            return X[0], type(rep)(
                iter=rep.iter[0], solution_error=rep.solution_error[0])
        corr = self._route_corr(None, max_iterations)
        return self._fn(max_iterations, batched=False, corr=corr)(
            self._A, self._G, y, tolerance)

    def solve_batch_on_device(self, Y: jnp.ndarray, tolerance,
                              max_iterations: int = 100,
                              dense: bool = True):
        """Jit-composable batched solve over device arrays.
        ``dense=False`` returns ((values, indices), report) — the
        compact slot-space solution (see ``solve_batch``). Under
        precision="certified" the report carries the high-precision
        certificate but the data-dependent re-solve lives only in
        ``solve_batch`` — check ``solution_error <= tolerance``
        per lane downstream."""
        if self._mesh is not None:
            from .parallel import sharding as _sh
            A, G = self._mesh_arrays()
            Y, bpad = _mesh_pad_jit(self._mesh, Y, A.shape[0])
            out = _sh.omp_sharded(
                self._mesh, A, Y, tolerance, max_iterations,
                k_max=self._resolved_k_max(max_iterations),
                gram=self._mesh_gram_arg(), G=G,
                precision=self._precision, dense=dense,
                picks=self._picks)
            rep = out[-1]
            X = out[0] if dense else (out[0], out[1])
            X, rep = _trim_batch(X, rep, bpad, dense)
            return ((X[0], X[1]), rep) if not dense else (X, rep)
        if self._route_driver(int(Y.shape[0]), max_iterations):
            return self._fn(max_iterations, batched=True, driver=True,
                            dense=dense)(
                self._A, self._G, Y, tolerance)
        corr = self._route_corr(int(Y.shape[0]), max_iterations)
        return self._fn(max_iterations, batched=True, corr=corr,
                        dense=dense)(self._A, self._G, Y, tolerance)

    def _tol(self, tolerance):
        return (_default_tolerance(self.dtype)
                if tolerance is None else float(tolerance))


class Cosamp:
    """CoSaMP — Compressive Sampling Matching Pursuit over a fixed
    sensing matrix A (m×n), target sparsity ``k_sparsity``
    (Needell–Tropp 2009; beyond-reference greedy family, completing the
    wing next to ``Omp``/gOMP).

    Unlike OMP's insert-only support, each round REPLACES the support:
    the 2k largest inactive correlations join the current k support
    columns, one least-squares solve runs on the ≤ 3k union, and the k
    largest entries survive — wrong early picks get evicted (the RIP
    recovery guarantee's mechanism). Fixed-shape design: no online
    inverse — each round gathers the union into an (m, 3k) block and
    Choleskys its 3k×3k Gram (solvers/cosamp.py; fixed shapes
    throughout, sentinel-padded support). NumPy oracle:
    oracle/cosamp.py, matched round-for-round.

    ``k_sparsity`` is REQUIRED (CoSaMP's defining input — it prunes to
    exactly k); ``max_iterations`` counts rounds (default 20: CoSaMP
    converges geometrically under RIP, unlike OMP's k picks).
    ``precision`` pins the matmul precision ("highest"
    default — the round's Gram feeds a Cholesky). jax engine (no
    native twin; batching is one vmapped program). ``mesh=`` routes
    through ``parallel.sharding.cosamp_sharded`` (rows psum'd per
    round, like the other façades)."""

    def __init__(self, A, k_sparsity: int, precision: str = "highest",
                 engine: str = "jax", mesh=None):
        if engine not in ("auto", "jax"):
            raise ValueError(
                "Cosamp runs on the jax engine (no native twin); got "
                f"engine={engine!r}")
        if precision not in ("highest", "high", "default"):
            raise ValueError(
                "precision must be 'highest', 'high' or 'default', "
                f"got {precision!r}")
        if mesh is not None:
            _check_mesh(mesh, engine)
        self._A = ndview.as_matrix(A)
        self._m, self._n = self._A.shape
        if not isinstance(k_sparsity, int) or k_sparsity < 1:
            raise ValueError(
                f"k_sparsity must be an int >= 1, got {k_sparsity!r}")
        if k_sparsity >= min(self._m, self._n):
            raise ValueError(
                "k_sparsity must be < min(m, n) = "
                f"{min(self._m, self._n)} (the round needs a nonempty "
                f"inactive candidate pool and an overdetermined union "
                f"LS), got {k_sparsity}")
        self._k = k_sparsity
        self._precision = precision
        self._mesh = mesh
        self._A_mesh = None  # lazy row-sharded placement
        self._cache: dict = {}

    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self):
        return self._A.dtype

    def explain(self, batch: int | None = None,
                max_iterations: int = 20) -> dict:
        plan = {"engine": "jax", "backend": jax.default_backend(),
                "mode": "cosamp", "precision": self._precision,
                "k_sparsity": self._k,
                "union_capacity": self._k + min(2 * self._k,
                                                self._n - self._k,
                                                self._m - self._k),
                "formulation": (("vmapped " if batch is not None else "")
                                + "CoSaMP rounds (union LS via "
                                "3k-Gram Cholesky)")}
        if self._mesh is not None:
            plan["mesh"] = dict(self._mesh.shape)
            plan["sharded"] = True
            plan["formulation"] = ("row+data shard_map CoSaMP (psum'd "
                                   "proxy + union Gram per round)")
        return plan

    def _solve_batch_mesh(self, Y, tol, max_iterations: int):
        from .parallel import sharding as _sh
        if self._A_mesh is None:
            self._A_mesh = _mesh_place_rows(self._mesh, self._A)
        Yd, bpad = _mesh_prep_batch(self._mesh, Y, self._A_mesh.shape[0])
        X, rep = _sh.cosamp_sharded(
            self._mesh, self._A_mesh, Yd, self._k, tol,
            max_iterations=max_iterations, precision=self._precision,
            m_global=self._m)
        return _trim_batch(X, rep, bpad, dense=True)

    def _fn(self, max_iterations: int, batched: bool):
        _check_max_iterations(max_iterations)
        from .solvers import cosamp as _cosamp
        key = ("cosamp", max_iterations, batched)
        fn = self._cache.get(key)
        if fn is None:
            def core(A, y, tol):
                with _blas.precision_scope(self._precision):
                    return _cosamp.solve_cosamp(
                        A, y, self._k, tol,
                        max_iterations=max_iterations)
            run = (jax.vmap(core, in_axes=(None, 0, None)) if batched
                   else core)
            fn = jax.jit(run)
            self._cache[key] = fn
        return fn

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 20):
        """Recover a k-sparse x with y ≈ Ax; returns (x, OmpReport)
        (the greedy family's report shape: iter = rounds,
        solution_error = final ‖y − Ax‖₂)."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        if self._mesh is not None:
            X, rep = self._solve_batch_mesh(y[None, :], tol,
                                            max_iterations)
            x, it, err = jax.device_get(
                (X[0], rep.iter[0], rep.solution_error[0]))
            return x, OmpReport(iter=int(it), solution_error=float(err))
        x, rep = self._fn(max_iterations, batched=False)(self._A, y, tol)
        x, it, err = jax.device_get((x, rep.iter, rep.solution_error))
        return x, OmpReport(iter=int(it), solution_error=float(err))

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 20):
        """Batched solve over signals B of shape (batch, m)."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m)
        tol = self._tol(tolerance)
        if self._mesh is not None:
            return self._solve_batch_mesh(Y, tol, max_iterations)
        return self._fn(max_iterations, batched=True)(self._A, Y, tol)

    def solve_on_device(self, y: jnp.ndarray, tolerance,
                        max_iterations: int = 20):
        """Jit-composable solve: device arrays in, (x, report) out."""
        if self._mesh is not None:
            X, rep = self.solve_batch_on_device(y[None, :], tolerance,
                                                max_iterations)
            return X[0], type(rep)(
                iter=rep.iter[0], solution_error=rep.solution_error[0])
        return self._fn(max_iterations, batched=False)(
            self._A, y, tolerance)

    def solve_batch_on_device(self, Y: jnp.ndarray, tolerance,
                              max_iterations: int = 20):
        """Jit-composable batched solve over device arrays."""
        if self._mesh is not None:
            from .parallel import sharding as _sh
            if self._A_mesh is None:
                self._A_mesh = _mesh_place_rows(self._mesh, self._A)
            Y, bpad = _mesh_pad_jit(self._mesh, Y, self._A_mesh.shape[0])
            X, rep = _sh.cosamp_sharded(
                self._mesh, self._A_mesh, Y, self._k, tolerance,
                max_iterations=max_iterations,
                precision=self._precision, m_global=self._m)
            return _trim_batch(X, rep, bpad, dense=True)
        return self._fn(max_iterations, batched=True)(
            self._A, Y, tolerance)

    def _tol(self, tolerance):
        return (_default_tolerance(self.dtype)
                if tolerance is None else float(tolerance))


def _compact_from_dense(X, k_max: int):
    """Host-side compact (values, indices) form of a dense batch
    solution — the native engine's ``dense=False`` leg. Each lane's
    nonzero coordinates (≤ k_max by the active-set capacity) padded
    with the sentinel n; scatter(values, indices) == X by construction
    (a zero-valued active coordinate contributes nothing either way)."""
    X = np.asarray(X)
    b, n = X.shape
    vals = np.zeros((b, k_max), X.dtype)
    idxs = np.full((b, k_max), n, np.int32)
    for lane in range(b):
        nz = np.flatnonzero(X[lane])[:k_max]
        vals[lane, : len(nz)] = X[lane, nz]
        idxs[lane, : len(nz)] = nz
    return vals, idxs


def _compact_from_dense_jax(X, k_max: int):
    """Jittable counterpart of ``_compact_from_dense``: per lane, the
    ≤ k_max nonzero coordinates in ascending index order (a stable
    argsort of the zero mask), sentinel n beyond them. Same caveat: an
    exactly-zero active coordinate is indistinguishable from inactive
    in the dense form and contributes nothing either way."""
    b, n = X.shape
    nz = X != 0
    order = jnp.argsort(~nz, axis=1, stable=True)[:, :k_max].astype(
        jnp.int32)
    vals = jnp.take_along_axis(X, order, axis=1)
    keep = jnp.take_along_axis(nz, order, axis=1)
    return jnp.where(keep, vals, 0), jnp.where(keep, order, n)


def densify_batch(values, indices, n: int):
    """Scatter a compact slot-space batch solution (``solve_batch(...,
    dense=False)``) back to the dense (batch, n) form — see
    solvers/homotopy_batch.densify_batch."""
    return np.asarray(_homotopy_batch.densify_batch(values, indices, n))


def densify_path(lambdas, values, indices, iters: int, n: int):
    """Reconstruct one dense regularization path from the compact
    slot-space history (``Homotopy.solve_path`` / ``solve_path_batch``).

    lambdas: (H,), values/indices: (H, k_max) with sentinel index n for
    empty slots; ``iters`` the lane's report.iter. Returns
    (lambdas (T,), Xs (T, n)) with the break-terminated duplicate row
    trimmed (see solvers/homotopy.py record_path)."""
    lambdas = np.asarray(lambdas)
    values = np.asarray(values)
    indices = np.asarray(indices)
    T = int(iters) + 1
    Xs = np.zeros((T, n), values.dtype)
    hv, hi = values[:T], indices[:T]
    valid = hi < n
    rows = np.broadcast_to(np.arange(T)[:, None], hi.shape)
    Xs[rows[valid], hi[valid]] = hv[valid]
    lam = lambdas[:T]
    # a break-terminated path's final iteration commits nothing and
    # records a duplicate of the previous breakpoint — trim it
    if T >= 2 and lam[-1] == lam[-2] and np.array_equal(Xs[-1], Xs[-2]):
        lam, Xs = lam[:-1], Xs[:-1]
    return lam, Xs


def lasso_at(lambdas, Xs, lam):
    """Exact LASSO solution at an arbitrary λ from a recorded
    regularization path (beyond reference).

    The homotopy path x(λ) of min ½‖y−Ax‖² + λ‖x‖₁ is PIECEWISE LINEAR
    in λ between breakpoints (the loop's own γ-steps — docs/
    algorithms.md §1; the reference only ever returns the endpoint,
    homotopy-cpu.cpp:274), so the solution at any λ between recorded
    breakpoints is the exact linear interpolation

        x(λ) = x_t + (λ_t − λ) / (λ_t − λ_{t+1}) · (x_{t+1} − x_t)

    over the FIRST bracket [λ_{t+1}, λ_t] containing λ (first crossing:
    adversarial paths can transiently raise λ — solve_path docs).
    Inputs are ``Homotopy.solve_path``'s outputs. λ ≥ λ₀ returns x = 0
    (the path's λ-max end); λ below the recorded end returns the final
    iterate (the path only extends down to its stopping tolerance —
    re-solve with a smaller tolerance for smaller λ). The returned x
    satisfies the LASSO KKT conditions at λ exactly up to the path's
    own fp resolution (tested: ‖Aᵀ(y−Ax)‖∞ = λ and active-coordinate
    sign agreement)."""
    lambdas = np.asarray(lambdas)
    Xs = np.asarray(Xs)
    lam = float(lam)
    if lam >= lambdas[0]:
        return np.zeros_like(Xs[0])
    for t in range(len(lambdas) - 1):
        hi, lo = lambdas[t], lambdas[t + 1]
        if hi >= lam >= lo and hi > lo:
            w = (hi - lam) / (hi - lo)
            return Xs[t] + w * (Xs[t + 1] - Xs[t])
    return Xs[-1].copy()


def lasso_at_batch(lambdas, values, indices, iters, n: int, lam):
    """Batched ``lasso_at`` over ``Homotopy.solve_path_batch``'s compact
    histories: one dense (batch, n) solution at λ, each lane
    interpolated on its own path. Works directly on the compact
    slot-space rows — only the (≤ 2) bracketing breakpoints are ever
    densified, O(batch·(T + n)) instead of densifying whole (T, n)
    sweeps (review finding)."""
    lambdas = np.asarray(lambdas)
    values = np.asarray(values)
    indices = np.asarray(indices)
    iters = np.asarray(iters)
    lam = float(lam)
    b = lambdas.shape[0]
    out = np.zeros((b, n), values.dtype)

    def row(vi, ii):
        r = np.zeros(n, values.dtype)
        valid = ii < n
        r[ii[valid]] = vi[valid]
        return r

    for i in range(b):
        T = int(iters[i]) + 1
        la, hv, hi = lambdas[i, :T], values[i, :T], indices[i, :T]
        # densify_path's duplicate-trim semantics for break-terminated
        # lanes (the final row repeats the previous breakpoint)
        if (T >= 2 and la[-1] == la[-2]
                and np.array_equal(row(hv[-1], hi[-1]),
                                   row(hv[-2], hi[-2]))):
            la, hv, hi = la[:-1], hv[:-1], hi[:-1]
        if lam >= la[0]:
            continue  # the λ-max end: x = 0
        for t in range(len(la) - 1):
            top, bot = la[t], la[t + 1]
            if top >= lam >= bot and top > bot:
                w = (top - lam) / (top - bot)
                x0 = row(hv[t], hi[t])
                out[i] = x0 + w * (row(hv[t + 1], hi[t + 1]) - x0)
                break
        else:
            out[i] = row(hv[-1], hi[-1])  # below the recorded end
    return out


def reconstruct_signal(A, x):
    """y = A @ x (reference: ss.h:79-84, lib.cpp reconstruct_signal)."""
    A = ndview.as_matrix(A)
    xv = ndview.as_vector(x, dtype=A.dtype, size=A.shape[1])
    return np.asarray(_blas.xgemv(A, xv))


def norm_l1(A):
    """L1-normalize the columns of A (reference: ss.h:88-93, norms.h)."""
    A = ndview.as_matrix(A)
    return np.asarray(_norms.l1_columns(A))
