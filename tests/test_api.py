"""Public-API tests — port of the reference Python binding suite
(reference: bindings/python/tests/test_binding.py): per-dtype identity smoke
(`solution_error == 0`, `iter == 1`), NumPy view semantics (row/column
subsets, transpose), plus default-argument and error-path behavior of the
binding (binding.cpp:89-111).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import sparse_solvers_tpu as ss


def _test_smoke(Solver, N, dtype):
    # test_binding.py:9-20
    A = np.identity(N, dtype=dtype)
    solver = Solver(A)
    for n in range(N - 1):
        signal = np.zeros(N, dtype=dtype)
        signal[n] = 1
        x, info = solver.solve(signal)
        assert np.array_equal(signal, x)
        assert info.solution_error == 0
        assert info.iter == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_homotopy_smoke(dtype):
    _test_smoke(ss.Homotopy, 5, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_irls_smoke(dtype):
    _test_smoke(ss.Irls, 5, dtype)


def test_homotopy_row_subset():
    # test_binding.py:31-42
    rng = np.random.RandomState(0)
    A = rng.rand(10, 5) * 0.1
    A_sub = A[:5, :]
    A_sub[:, 0] = 1

    signal = np.ones(5)
    x, info = ss.Homotopy(A_sub).solve(signal)
    assert len(x) == 5
    assert np.count_nonzero(x) == 1


def test_homotopy_col_subset():
    # test_binding.py:44-56
    rng = np.random.RandomState(0)
    A = rng.rand(10, 5) * 0.1
    A[:, 0] = 1
    A[:, 3] = 1

    A_sub = A[:, 2:]
    signal = np.ones(10)
    x, info = ss.Homotopy(A_sub).solve(signal)
    assert len(x) == 3
    assert np.argmax(x) == 1


def test_homotopy_transpose():
    # test_binding.py:58-68
    rng = np.random.RandomState(0)
    A = rng.rand(5, 10) * 0.1
    A[3, :] = 1

    signal = np.ones(10)
    x, info = ss.Homotopy(A.T).solve(signal)
    assert len(x) == 5
    assert np.argmax(x) == 3


def test_version():
    v = ss.version()
    assert len(v) == 3


def test_irls_underdetermined_rejected():
    # irls_test.cpp: "underdetermined systems not supported"
    with pytest.raises(ValueError, match="m >= n"):
        ss.Irls(np.zeros((3, 5), np.float32))


def test_signal_length_mismatch():
    solver = ss.Homotopy(np.identity(5, np.float32))
    with pytest.raises(ValueError):
        solver.solve(np.ones(4, np.float32))


def test_zero_iteration_budget_rejected():
    # reference caller contract: assert(max_iter > 0)
    # (homotopy-cpu.cpp:193, irls-cpu.cpp:75); a zero budget has no
    # defined do-while semantics and the engines diverge on it
    A = np.identity(5, np.float32)
    y = np.eye(5, dtype=np.float32)[2]
    for solver in (ss.Homotopy(A), ss.Irls(A),
                   ss.IrlsCg(np.ones((4, 8), np.float32))):
        b = y if solver.shape[0] == 5 else np.ones(4, np.float32)
        with pytest.raises(ValueError, match="max_iterations"):
            solver.solve(b, max_iterations=0)
        with pytest.raises(ValueError, match="max_iterations"):
            solver.solve_batch(np.stack([b]), max_iterations=-1)
        with pytest.raises(ValueError, match="max_iterations"):
            solver.solve_batch_on_device(jnp.stack([jnp.asarray(b)]),
                                         1e-3, max_iterations=0)


def test_reference_readme_example_verbatim():
    """The reference README's toy program (README.md:14-33) runs under
    this package with only the import line changed (docs/migration.md).
    float64 inputs exercise the dtype-follows-A path (binding.cpp:69-86).
    """
    N = 10
    np.random.seed(101)
    A = np.random.normal(loc=0.025, scale=0.025, size=(N, N)) + np.identity(N)
    signal = np.zeros(N)
    signal[2] = 1

    x, info = ss.Homotopy(A).solve(signal, tolerance=0.1)

    assert np.argmax(x) == 2
    assert info.solution_error <= 0.1
    assert 1 - np.count_nonzero(x) / np.double(N) >= 0.5
    assert 1 <= info.iter <= 100


def test_reports_repr_fields():
    # report field names are part of the API (README.md:30-33)
    A = np.identity(4, np.float32)
    x, hrep = ss.Homotopy(A).solve(np.eye(4, dtype=np.float32)[0])
    assert hasattr(hrep, "iter") and hasattr(hrep, "solution_error")
    x, irep = ss.Irls(A).solve(np.eye(4, dtype=np.float32)[0])
    assert hasattr(irep, "spd_failure")


def test_solve_batch_on_device_jit_composable():
    """solve_batch_on_device composes under an outer jit (the serving-loop
    entry point) and matches solve_batch's jax path lane for lane."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    m, n, b = 24, 48, 5
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Xt = np.zeros((b, n), np.float32)
    for i in range(b):
        Xt[i, rng.choice(n, 4, replace=False)] = 1.0
    Y = Xt @ A.T

    solver = ss.Homotopy(A, engine="jax")

    @jax.jit
    def serve(Yd, tol):
        X, rep = solver.solve_batch_on_device(Yd, tol, max_iterations=40)
        # post-process on device to prove composability
        return X, rep.iter, jnp.abs(X).sum(axis=1)

    X1, it1, l1 = serve(jnp.asarray(Y), 1e-2)
    X2, rep2 = solver.solve_batch(Y, tolerance=1e-2, max_iterations=40)
    # inlined-G vs cached-G are different compiled programs; the matmul
    # schedules may differ by ulps, so parity here is tight-allclose (the
    # bit-exact contract is within one compiled program)
    np.testing.assert_allclose(np.asarray(X1), np.asarray(X2), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(it1), np.asarray(rep2.iter))

    irls = ss.Irls(A.T.copy(), engine="jax")  # m >= n
    Yi = (A.T @ np.ones(m, np.float32))[None, :].repeat(3, axis=0)
    Xi, repi = jax.jit(
        lambda Yd, tol: irls.solve_batch_on_device(Yd, tol, 20))(
            jnp.asarray(Yi), 1e-4)
    Xi2, repi2 = irls.solve_batch(Yi, tolerance=1e-4, max_iterations=20)
    np.testing.assert_array_equal(np.asarray(Xi), np.asarray(Xi2))
    np.testing.assert_array_equal(np.asarray(repi.spd_failure),
                                  np.asarray(repi2.spd_failure))


def test_engine_jax_small_problem_warns():
    """Forcing engine="jax" below the dispatch-latency floor warns
    (the ~82 ms flat device round trip dwarfs sub-millisecond solves;
    BASELINE.md small-problem note)."""
    import warnings

    A = np.eye(16, dtype=np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ss.Homotopy(A, engine="jax")
        ss.Irls(A, engine="jax")
    msgs = [str(x.message) for x in w if x.category is RuntimeWarning]
    assert sum("dispatch latency" in m for m in msgs) == 2
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ss.Homotopy(A)  # auto: no warning
    assert not [x for x in w if x.category is RuntimeWarning]


def test_explain_reports_executed_path(monkeypatch):
    """explain() must agree with the path the compiled-program cache
    actually records (same routing helper feeds both), and reveal the
    engine choice users otherwise can't see (round-1 review: eligibility
    routing had no telemetry)."""
    rng = np.random.RandomState(11)
    A = rng.randn(40, 80).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)

    # auto on a small problem: native host engine
    from sparse_solvers_tpu.backend import native
    if native.available():
        plan = ss.Homotopy(A).explain()
        assert plan["engine"] == "native"

    # forced jax, batched, forced slot-space driver
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    s = ss.Homotopy(A, engine="jax")
    plan = s.explain(batch=6, max_iterations=20)
    assert plan["engine"] == "jax" and plan["batch_native"]
    assert "slot-space" in plan["formulation"]
    Y = (A @ rng.randn(80).astype(np.float32))[None, :].repeat(6, 0)
    s.solve_batch(Y, tolerance=0.01, max_iterations=20)
    (key,) = s._cache.keys()
    assert key[4] == plan["batch_native"]
    assert key[1] == plan["k_max"]
    assert key[3] == plan["sparse_matvec"]

    # vmapped core when the driver is disabled
    monkeypatch.setenv("SS_BATCH_NATIVE", "0")
    plan = s.explain(batch=6, max_iterations=20)
    assert not plan["batch_native"] and "vmapped" in plan["formulation"]

    plan = ss.Irls(np.eye(8, dtype=np.float32), engine="jax").explain()
    assert plan["engine"] == "jax" and not plan["qr_cached"]


def test_irls_precision_knob():
    """Irls accepts the matmul precision values (no certified variant —
    its solution_error is the reweighting eps, not a residual); results
    are identical across settings on the CPU backend."""
    import numpy as np
    import sparse_solvers_tpu as ss

    rng = np.random.RandomState(0)
    A = rng.randn(64, 32).astype(np.float32)
    y = (A @ np.eye(32, dtype=np.float32)[3]).astype(np.float32)
    x0, r0 = ss.Irls(A, engine="jax").solve(y, tolerance=0.1)
    x1, r1 = ss.Irls(A, engine="jax", precision="high").solve(
        y, tolerance=0.1)
    np.testing.assert_allclose(np.asarray(x0), np.asarray(x1), atol=1e-6)
    assert r0.iter == r1.iter
    try:
        ss.Irls(A, precision="certified")
        raise AssertionError("should have raised")
    except ValueError:
        pass


def test_homotopy_update_column_matches_rebuild():
    """update_column (serving gallery churn): the incrementally updated
    device A and Gram row/col must give the same solves as a freshly
    constructed solver on the updated matrix — same iteration counts,
    reference-tolerance agreement (the Gram row is recomputed with the
    same contraction settings, so only ulp-level accumulation order can
    differ)."""
    import jax.numpy as jnp
    rng = np.random.RandomState(8)
    m, n, k = 48, 96, 4
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    s = ss.Homotopy(A, engine="jax")
    _ = s._G  # force the Gram cache so the incremental path runs
    new_col = rng.randn(m).astype(np.float32)
    new_col /= np.linalg.norm(new_col)
    s.update_column(5, new_col)

    A2 = A.copy(); A2[:, 5] = new_col
    s2 = ss.Homotopy(A2, engine="jax")
    x0 = np.zeros(n, np.float32)
    x0[[5, 17, 40, 63]] = [1.0, 0.7, 0.5, 0.9]
    y = A2 @ x0
    xa, ra = s.solve(y, tolerance=1e-3, max_iterations=60)
    xb, rb = s2.solve(y, tolerance=1e-3, max_iterations=60)
    assert ra.iter == rb.iter
    np.testing.assert_allclose(xa, xb, atol=1e-5)
    # the updated Gram really is AᵀA of the updated matrix
    np.testing.assert_allclose(np.asarray(s._G), A2.T @ A2, atol=1e-5)
    with np.testing.assert_raises(ValueError):
        s.update_column(n, new_col)
    with np.testing.assert_raises(ValueError):
        s.update_column(0, new_col[:-1])


def test_irls_cg_update_column():
    """IrlsCg.update_column: factorization-free, so the update is just
    the device matrix write; solves match a fresh solver exactly."""
    rng = np.random.RandomState(9)
    m, n = 24, 96
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    s = ss.IrlsCg(A, engine="jax")
    new_col = rng.randn(m).astype(np.float32)
    new_col /= np.linalg.norm(new_col)
    s.update_column(7, new_col)
    A2 = A.copy(); A2[:, 7] = new_col
    x0 = np.zeros(n, np.float32); x0[[7, 30]] = [1.0, 0.6]
    y = A2 @ x0
    xa, ra = s.solve(y, tolerance=1e-5, max_iterations=60)
    xb, rb = ss.IrlsCg(A2, engine="jax").solve(y, tolerance=1e-5,
                                               max_iterations=60)
    assert ra.iter == rb.iter
    np.testing.assert_array_equal(xa, xb)


def test_solve_path_regularization_breakpoints():
    """solve_path (beyond reference): records the LARS/LASSO breakpoints
    the loop already visits. Contract: lambda strictly decreases from
    ‖Aᵀy‖∞; every breakpoint satisfies its own KKT identity
    ‖Aᵀ(y−Ax_t)‖∞ = λ_t; the final row equals solve()."""
    rng = np.random.RandomState(3)
    m, n, k = 64, 128, 5
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    x0 = np.zeros(n, np.float32)
    x0[rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1, k)
    y = A @ x0

    s = ss.Homotopy(A, engine="jax")
    lambdas, Xs, rep = s.solve_path(y, tolerance=1e-3, max_iterations=60)
    assert len(lambdas) == rep.iter + 1 == Xs.shape[0]
    assert np.all(np.diff(lambdas) < 0)  # strictly decreasing
    assert np.abs(Xs[0]).max() == 0.0
    np.testing.assert_allclose(lambdas[0], np.max(np.abs(A.T @ y)),
                               rtol=1e-6)
    for t in range(len(lambdas)):
        np.testing.assert_allclose(
            np.max(np.abs(A.T @ (y - A @ Xs[t]))), lambdas[t],
            rtol=1e-4, atol=1e-6)
    xf, repf = s.solve(y, tolerance=1e-3, max_iterations=60)
    assert repf.iter == rep.iter
    np.testing.assert_allclose(Xs[-1], xf, atol=1e-6)


def test_solve_path_break_terminated_records_committed_breakpoints():
    """A break-terminated path (empty-set break: the single active
    member's removal candidate wins) must record only COMMITTED
    breakpoints — the break iteration changes nothing and its duplicate
    row is trimmed, so the final path row still equals solve()'s x and
    every row keeps its KKT identity (review finding: the pre-fix code
    recorded the post-toggle, emptied support)."""
    rng = np.random.RandomState(0)
    m, n = 16, 3
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    y = (-A[:, 0] + 0.4 * A[:, 1]).astype(np.float32)
    s = ss.Homotopy(A, engine="jax")
    lambdas, Xs, rep = s.solve_path(y, tolerance=1e-3, max_iterations=30)
    xf, repf = s.solve(y, tolerance=1e-3, max_iterations=30)
    assert rep.iter == repf.iter
    np.testing.assert_allclose(Xs[-1], xf, atol=1e-6)
    # the break iteration's duplicate row was trimmed
    assert len(lambdas) == rep.iter
    # NOTE no monotonicity assert: on this adversarial fixture the
    # reference's initial-direction quirk (sign(|c|_inf) = +1 with a
    # negative max correlation, homotopy-cpu.cpp:223-227) moves x the
    # wrong way first and lambda transiently INCREASES — recorded as-is.
    # The KKT identity still holds at every recorded breakpoint:
    for t in range(len(lambdas)):
        np.testing.assert_allclose(
            np.max(np.abs(A.T @ (y - A @ Xs[t]))), lambdas[t],
            rtol=1e-4, atol=1e-6)


def test_solve_path_batch_matches_single_paths():
    """solve_path_batch returns compact per-lane histories; densify_path
    on each lane reconstructs exactly the single-signal solve_path."""
    rng = np.random.RandomState(6)
    m, n, k, b = 64, 128, 4, 3
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = np.zeros((b, m), np.float32)
    for i in range(b):
        x0 = np.zeros(n, np.float32)
        x0[rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1, k)
        Y[i] = A @ x0
    s = ss.Homotopy(A, engine="jax")
    hl, hv, hi, rep = s.solve_path_batch(Y, tolerance=1e-3,
                                         max_iterations=40)
    iters = np.asarray(rep.iter)
    for i in range(b):
        lam_b, Xs_b = ss.densify_path(hl[i], hv[i], hi[i], int(iters[i]), n)
        lam_s, Xs_s, rep_s = s.solve_path(Y[i], tolerance=1e-3,
                                          max_iterations=40)
        assert rep_s.iter == iters[i]
        # vmapped vs single programs differ in accumulation order; the
        # final lambda sits at convergence noise level (~1e-7)
        np.testing.assert_allclose(lam_b, lam_s, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(Xs_b, Xs_s, atol=1e-6)


def test_solve_path_float64():
    """The path recording is dtype-generic: f64 paths carry the KKT
    identity at f64 resolution."""
    rng = np.random.RandomState(2)
    m, n, k = 48, 96, 3
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    x0 = np.zeros(n)
    x0[rng.choice(n, k, replace=False)] = rng.uniform(0.4, 1, k)
    y = A @ x0
    s = ss.Homotopy(A, engine="jax")
    lambdas, Xs, rep = s.solve_path(y, tolerance=1e-9, max_iterations=40)
    assert Xs.dtype == np.float64
    for t in range(len(lambdas)):
        np.testing.assert_allclose(
            np.max(np.abs(A.T @ (y - A @ Xs[t]))), lambdas[t],
            rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Xs[-1][x0 > 0], x0[x0 > 0], atol=1e-7)


def test_lasso_at_interpolates_exact_kkt():
    """lasso_at (round 5, beyond reference): the piecewise-linear path
    evaluated at arbitrary λ satisfies the LASSO KKT conditions —
    ‖Aᵀ(y−Ax)‖∞ = λ and every active coordinate's correlation equals
    λ·sign(x) — at fp resolution; endpoints clamp as documented."""
    rng = np.random.RandomState(12)
    m, n, k = 64, 128, 5
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    x0 = np.zeros(n, np.float32)
    x0[rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1, k)
    y = A @ x0
    s = ss.Homotopy(A, engine="jax")
    lambdas, Xs, rep = s.solve_path(y, tolerance=1e-3, max_iterations=60)
    # mid-bracket λs between several consecutive breakpoints
    for t in (0, len(lambdas) // 2, len(lambdas) - 2):
        lam = 0.5 * (lambdas[t] + lambdas[t + 1])
        x = ss.lasso_at(lambdas, Xs, lam)
        c = A.T @ (y - A @ x)
        np.testing.assert_allclose(np.max(np.abs(c)), lam,
                                   rtol=1e-4, atol=1e-6)
        act = np.abs(x) > 1e-7
        np.testing.assert_allclose(c[act], lam * np.sign(x[act]),
                                   rtol=1e-3, atol=1e-5)
    # λ at a breakpoint reproduces the recorded iterate
    np.testing.assert_allclose(ss.lasso_at(lambdas, Xs, lambdas[3]),
                               Xs[3], atol=1e-7)
    # λ above λ0 -> zero; λ below the recorded end -> final iterate
    assert np.all(ss.lasso_at(lambdas, Xs, 2 * lambdas[0]) == 0)
    np.testing.assert_allclose(
        ss.lasso_at(lambdas, Xs, lambdas[-1] / 2), Xs[-1], atol=0)


def test_lasso_at_batch_matches_single():
    rng = np.random.RandomState(13)
    m, n, k, b = 48, 96, 4, 5
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = np.zeros((b, m), np.float32)
    for i in range(b):
        x = np.zeros(n, np.float32)
        x[rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1, k)
        Y[i] = A @ x
    s = ss.Homotopy(A, engine="jax")
    hl, hv, hi, reps = s.solve_path_batch(Y, tolerance=1e-3,
                                          max_iterations=50)
    lam = 0.05
    Xb = ss.lasso_at_batch(hl, hv, hi, reps.iter, n, lam)
    for i in range(b):
        la, Xs = ss.densify_path(hl[i], hv[i], hi[i],
                                 int(reps.iter[i]), n)
        np.testing.assert_allclose(Xb[i], ss.lasso_at(la, Xs, lam),
                                   atol=0)
        c = A.T @ (Y[i] - A @ Xb[i])
        if la[0] > lam > la[-1]:
            np.testing.assert_allclose(np.max(np.abs(c)), lam,
                                       rtol=1e-4, atol=1e-6)


def test_readme_quickstart_runs_as_written():
    """The README's quickstart must work verbatim."""
    N = 10
    np.random.seed(101)
    A = np.random.randn(N, N).astype(np.float32) + np.eye(N,
                                                         dtype=np.float32)
    x_true = np.zeros(N, np.float32)
    x_true[2] = 1.0
    y = A @ x_true

    solver = ss.Homotopy(A)
    x, report = solver.solve(y, tolerance=0.1)
    assert int(np.argmax(x)) == 2
    assert float(np.mean(x == 0)) >= 0.8
    assert report.iter >= 1


def test_native_disabled_forced_engine_raises(monkeypatch):
    """SS_NATIVE_DISABLE=1 + engine="native": explain() still reports
    the native plan (a solve would attempt it — _route_native's probe
    contract), but the solve itself raises RuntimeError instead of
    silently degrading to the jax engine."""
    monkeypatch.setenv("SS_NATIVE_DISABLE", "1")
    A = np.identity(5, np.float32)
    solver = ss.Homotopy(A, engine="native")
    assert solver.explain()["engine"] == "native"
    with pytest.raises(RuntimeError, match="native engine requested"):
        solver.solve(np.eye(5, dtype=np.float32)[2])
    # auto quietly degrades to jax on the same problem
    x, rep = ss.Homotopy(A).solve(np.eye(5, dtype=np.float32)[2])
    assert rep.solution_error == 0.0


@pytest.mark.parametrize("env,gpu,sparse,want", [
    (None, True, False, True),     # GPU auto: the slot-space driver
    (None, True, True, False),     # the sparse rule is kept
    (None, False, False, False),   # CPU auto: the vmapped core
    ("1", False, True, True),      # forced anywhere structurally valid
    ("0", True, False, False),     # forbidden
])
def test_route_batch_native_platform_rule(monkeypatch, env, gpu, sparse,
                                          want):
    """route_batch_native is the one platform decision every façade and
    sharded route asks; SS_BATCH_NATIVE overrides it both ways."""
    from sparse_solvers_tpu.solvers import homotopy_batch as HB

    if env is None:
        monkeypatch.delenv("SS_BATCH_NATIVE", raising=False)
    else:
        monkeypatch.setenv("SS_BATCH_NATIVE", env)
    monkeypatch.setattr(HB, "on_gpu", lambda: gpu)
    assert HB.route_batch_native(8, np.float32, sparse) is want
    # structural: never for f64 or an empty batch, whatever the override
    assert not HB.route_batch_native(8, np.float64, sparse)
    assert not HB.route_batch_native(0, np.float32, sparse)


def test_gpu_route_compiles_plain_forms(monkeypatch):
    """On the GPU route (platform patched here) the façade plans the
    driver with the one-pass bf16 q product, and the plan it reports is
    the one that runs: plain XLA forms, compiled — the package has no
    interpreted kernel to fall back to."""
    import pathlib

    from sparse_solvers_tpu.solvers import homotopy_batch as HB

    monkeypatch.delenv("SS_BATCH_NATIVE", raising=False)
    monkeypatch.setattr(HB, "on_gpu", lambda: True)
    rng = np.random.RandomState(4)
    m, n, k, B = 48, 256, 4, 6     # B·k_max ≥ 2m: outside the sparse rule
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Xt = np.zeros((B, n), np.float32)
    for i in range(B):
        Xt[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1, k)
    Y = (Xt @ A.T).astype(np.float32)
    s = ss.Homotopy(A, engine="jax")
    plan = s.explain(batch=B, max_iterations=20)
    assert plan["batch_native"] and plan["bf16_q"]
    X, rep = s.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    (key,) = [k_ for k_ in s._cache if k_[4]]   # the driver was built
    txt = s._cache[key].lower(s._A, s._G, jnp.asarray(Y),
                              1e-2).compile().as_text()
    assert "slot_gamma_scan" in txt and "slot_q_product" in txt
    assert (np.asarray(rep.solution_error) <= 1e-2).all()
    for i in range(B):
        assert (set(np.flatnonzero(np.abs(np.asarray(X[i])) > 0.1))
                == set(np.flatnonzero(Xt[i])))
    pkg = pathlib.Path(ss.__file__).parent
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert "interpret=" not in text and "pallas" not in text, path


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets nothing in
    code; without it the cache goes to the fixed <checkout>/.jax_cache."""
    import os

    import jax

    from sparse_solvers_tpu.utils import config

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.use_compile_cache() == str(tmp_path)
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = config.use_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(ss.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
