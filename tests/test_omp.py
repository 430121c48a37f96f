"""Orthogonal Matching Pursuit — beyond-reference solver family.

Test strategy mirrors the reference's solver-fixture matrix
(src/solvers/test_util.h: smoke / noisy / recovery fixtures, dual-dtype
instantiation) plus this framework's own conventions: oracle parity
(independent dense-LS NumPy rewrite), jax/native engine parity, and
fast/exact mode parity.

Tolerance note: OMP's stop test squares the residual; f32 tolerances in
these tests stay ≥ 1e-3 so tol² sits above the rss rounding floor
(solvers/omp.py module docstring) — at tighter targets differently-
compiled programs may legitimately fork by one stall iteration.
"""

import numpy as np
import pytest

import sparse_solvers_tpu as ss
from sparse_solvers_tpu.backend import native
from sparse_solvers_tpu.oracle import omp as oracle


def _problem(m, n, k, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(dtype)
    A /= np.linalg.norm(A, axis=0)
    x = np.zeros(n, dtype)
    x[rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k).astype(dtype)
    return A, x, (A @ x).astype(dtype)


def _tol(dtype):
    # tol² must sit above the rss rounding floor (~eps·‖y‖²) of the
    # respective dtype — see the module docstring
    return 1e-3 if dtype == np.float32 else 1e-6


# ------------------------------------------------------------ smoke

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_identity_smoke_exact(dtype):
    """A = I recovers a one-hot signal exactly in one pick (the
    reference's smoke_test contract shape, test_util.h:27-55)."""
    I = np.eye(5, dtype=dtype)
    sig = np.zeros(5, dtype)
    sig[2] = 1.0
    x, rep = ss.Omp(I, engine="jax").solve(sig, tolerance=0.1)
    assert rep.iter == 1
    assert rep.solution_error == 0.0
    np.testing.assert_array_equal(x, sig)


def test_zero_signal_returns_zero():
    A, _, _ = _problem(16, 32, 2, seed=1)
    x, rep = ss.Omp(A, engine="jax").solve(np.zeros(16, np.float32),
                                           tolerance=1e-3)
    assert rep.iter == 0 and rep.solution_error == 0.0
    np.testing.assert_array_equal(x, np.zeros(32, np.float32))


# ----------------------------------------------------- oracle parity

@pytest.mark.parametrize("m,n,k,dtype", [
    (32, 64, 4, np.float32),
    (64, 128, 8, np.float32),
    (100, 25, 3, np.float32),        # overdetermined
    (48, 96, 5, np.float64),
    (96, 48, 6, np.float64),
])
def test_oracle_parity(m, n, k, dtype):
    """jax engine matches the independent dense-lstsq oracle: same pick
    count, solutions at reference property-test tolerances."""
    A, x_true, y = _problem(m, n, k, seed=m + n, dtype=dtype)
    tol = _tol(dtype)
    xo, ito, erro, picks = oracle.solve(A, y, tol, 100)
    x, rep = ss.Omp(A, engine="jax").solve(y, tolerance=tol,
                                           max_iterations=100)
    assert rep.iter == ito
    assert rep.solution_error <= tol
    np.testing.assert_allclose(x, xo, atol=2e-4)
    sup = set(np.flatnonzero(x_true != 0).tolist())
    assert set(np.flatnonzero(np.abs(x) > 10 * tol).tolist()) == sup


def test_oracle_degenerate_orthogonal_residual():
    """Oracle stall/degenerate guards (advisor finding, round 4): when
    every inactive correlation is exactly 0 with ‖r‖ > tol the oracle
    must stop without duplicating a support index (a duplicate
    fancy-index scatter silently drops a coefficient) instead of
    spinning to max_iterations."""
    # y orthogonal to every column: c = Aᵀy = 0 on the first pick
    A = np.zeros((4, 3), np.float64)
    A[:2, 0] = [1.0, 0.0]
    A[:2, 1] = [0.0, 1.0]
    A[:2, 2] = [1.0, 1.0]
    y = np.array([0.0, 0.0, 1.0, 1.0])
    x, it, err, picks = oracle.solve(A, y, tolerance=1e-6,
                                     max_iterations=50)
    assert it == 0 and picks == [] and np.all(x == 0)
    assert err == pytest.approx(np.sqrt(2.0))
    # rss stall: after the informative pick the residual cannot improve
    # (remaining residual orthogonal to the column space) — the oracle
    # stops with the iterate kept, like the engines' done guard
    y2 = np.array([1.0, 0.0, 1.0, 1.0])
    x2, it2, err2, picks2 = oracle.solve(A[:, :1], y2, tolerance=1e-6,
                                         max_iterations=50)
    assert it2 <= 2 and len(picks2) == len(set(picks2))
    assert err2 == pytest.approx(np.sqrt(2.0))


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_mode_parity(mode):
    A, x_true, y = _problem(64, 160, 6, seed=9)
    x, rep = ss.Omp(A, engine="jax", mode=mode).solve(
        y, tolerance=1e-3, max_iterations=60)
    xo, ito, _, _ = oracle.solve(A, y, 1e-3, 60)
    assert rep.iter == ito
    np.testing.assert_allclose(x, xo, atol=2e-4)


def test_gram_vs_gramfree_same_solution():
    """The Gram-gather formulation and the matvec formulation agree on
    the solution; the Gram path may take one extra stall pick at its
    documented rss floor but its reported error is the true residual."""
    A, x_true, y = _problem(128, 512, 12, seed=4)
    xg, rg = ss.Omp(A, engine="jax", gram=True).solve(
        y, tolerance=1e-3, max_iterations=60)
    xf, rf = ss.Omp(A, engine="jax", gram=False).solve(
        y, tolerance=1e-3, max_iterations=60)
    assert abs(rg.iter - rf.iter) <= 1
    assert rg.solution_error <= 1e-3 and rf.solution_error <= 1e-3
    np.testing.assert_allclose(xg, xf, atol=2e-4)


# ----------------------------------------------------- native engine

pytestmark_native = pytest.mark.skipif(
    not native.available(), reason="native backend unavailable")


@pytestmark_native
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_matches_oracle_and_jax(dtype):
    A, x_true, y = _problem(64, 128, 8, seed=3, dtype=dtype)
    tol = _tol(dtype)
    xo, ito, erro, _ = oracle.solve(A, y, tol, 100)
    xn, itn, errn = native.omp_solve(A, y, tol, 100, 100)
    xj, repj = ss.Omp(A, engine="jax").solve(y, tolerance=tol,
                                             max_iterations=100)
    assert itn == ito == repj.iter
    np.testing.assert_allclose(xn, xo, atol=2e-4)
    np.testing.assert_allclose(xn, xj, atol=2e-4)


@pytestmark_native
def test_native_batch_bit_equal():
    A, _, _ = _problem(48, 96, 5, seed=7)
    Y = np.stack([_problem(48, 96, 5, seed=s)[2] for s in range(6)])
    X, iters, errs = native.omp_solve_batch(A, Y, 1e-3, 50, 50)
    for b in range(6):
        xb, itb, errb = native.omp_solve(A, Y[b], 1e-3, 50, 50)
        assert iters[b] == itb and errs[b] == errb
        np.testing.assert_array_equal(X[b], xb)


@pytestmark_native
def test_auto_routes_small_to_native():
    A, x_true, y = _problem(32, 64, 4, seed=2)
    solver = ss.Omp(A)  # auto
    assert solver.explain()["engine"] == "native"
    x, rep = solver.solve(y, tolerance=1e-3)
    assert set(np.flatnonzero(np.abs(x) > 1e-2)) == \
        set(np.flatnonzero(x_true))


# ------------------------------------------------------------ batch

def test_solve_batch_matches_single():
    A, _, _ = _problem(64, 128, 6, seed=11)
    Y = np.stack([_problem(64, 128, 6, seed=s)[2] for s in range(4)])
    solver = ss.Omp(A, engine="jax")
    X, reps = solver.solve_batch(Y, tolerance=1e-3, max_iterations=50)
    X = np.asarray(X)
    for b in range(4):
        xb, repb = solver.solve(Y[b], tolerance=1e-3, max_iterations=50)
        # batched and single programs compile separately; solutions
        # agree within f32 reorder noise
        np.testing.assert_allclose(X[b], xb, atol=2e-4)
        assert abs(int(np.asarray(reps.iter)[b]) - repb.iter) <= 1


def test_solve_on_device_jit_composable():
    import jax
    A, x_true, y = _problem(48, 96, 4, seed=13)
    solver = ss.Omp(A, engine="jax")

    @jax.jit
    def pipeline(y):
        x, rep = solver.solve_on_device(y, 1e-3, max_iterations=40)
        return x, rep.iter

    x, it = pipeline(y)
    assert int(it) == 4
    assert set(np.flatnonzero(np.abs(np.asarray(x)) > 1e-2)) == \
        set(np.flatnonzero(x_true))


# ------------------------------------------------- robustness / edges

def test_k_max_caps_support():
    A, x_true, y = _problem(64, 128, 8, seed=5)
    x, rep = ss.Omp(A, engine="jax", k_max=3).solve(
        y, tolerance=1e-6, max_iterations=50)
    assert rep.iter == 3
    assert np.count_nonzero(x) <= 3
    assert np.isfinite(rep.solution_error)


def test_degenerate_duplicate_columns_break_finite():
    """A dictionary of duplicated columns makes every post-rank pick
    degenerate — the guard must stop with a finite LS solution instead
    of an inf/NaN inverse."""
    rng = np.random.RandomState(8)
    base = rng.randn(24, 6).astype(np.float32)
    A = np.concatenate([base] * 8, axis=1)  # 24 x 48, rank 6
    A /= np.linalg.norm(A, axis=0)
    y = (A[:, :3] @ np.array([1.0, -0.5, 0.8], np.float32)).astype(np.float32)
    for engine in ("jax",) + (("native",) if native.available() else ()):
        x, rep = ss.Omp(A, engine=engine).solve(y, tolerance=1e-7,
                                                max_iterations=40)
        assert np.isfinite(np.asarray(x)).all(), engine
        assert np.isfinite(rep.solution_error), engine
        assert rep.iter <= 7, engine  # rank bound (+1 boundary pick)


def test_noise_floor_stall_stops():
    """Below the f32 rss floor the stall detector must stop the loop
    rather than padding the support until max_iterations."""
    A, x_true, y = _problem(128, 512, 12, seed=4)
    x, rep = ss.Omp(A, engine="jax").solve(y, tolerance=1e-30,
                                           max_iterations=100)
    assert rep.iter < 100
    assert np.isfinite(rep.solution_error)


def test_update_column_refreshes_gram():
    A, x_true, y = _problem(48, 96, 4, seed=17)
    solver = ss.Omp(A, engine="jax")
    solver.solve(y, tolerance=1e-3)  # builds the Gram cache
    rng = np.random.RandomState(99)
    v = rng.randn(48).astype(np.float32)
    v /= np.linalg.norm(v)
    solver.update_column(7, v)
    x0 = np.zeros(96, np.float32)
    x0[7] = 1.0
    y2 = np.asarray(solver._A) @ x0
    x, rep = solver.solve(y2, tolerance=1e-3)
    assert np.argmax(np.abs(x)) == 7 and rep.iter == 1


# ------------------------------------------------------- validation

def test_validation_errors():
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError):
        ss.Omp(A, mode="bogus")
    with pytest.raises(ValueError):
        ss.Omp(A, engine="cuda")
    with pytest.raises(ValueError):
        ss.Omp(A, engine="native", mode="exact")
    with pytest.raises(ValueError):
        ss.Omp(A, precision="bogus")
    with pytest.raises(ValueError):
        ss.Omp(A, mode="exact", precision="certified")
    with pytest.raises(ValueError):
        # exact mode never reads the cached Gram (built at fast-path
        # precision) — pinning it is a contradiction, not a no-op
        ss.Omp(A, mode="exact", gram=True)
    with pytest.raises(ValueError):
        ss.Omp(A, k_max=0)
    with pytest.raises(ValueError):
        ss.Omp(A).solve(np.zeros(8, np.float32), max_iterations=0)
    with pytest.raises(ValueError):
        ss.Omp(A).solve(np.zeros(7, np.float32))


def test_corr_formulations_agree():
    """All three correlation-update formulations (gram / sparse / dense,
    solve_omp_core ``corr``) visit the same pick sequence and solution
    at robust tolerances — they are algebraically identical ways to
    compute c = c0 − (AᵀA)x̂."""
    import jax
    import jax.numpy as jnp
    from sparse_solvers_tpu.ops.operators import DenseOperator
    from sparse_solvers_tpu.solvers.omp import solve_omp_core

    A, x_true, y = _problem(96, 256, 7, seed=29)
    G = (A.T @ A).astype(np.float32)
    outs = {}
    for corr in ("gram", "sparse", "dense"):
        fn = jax.jit(lambda a, g, b: solve_omp_core(
            DenseOperator(a, g), a.shape[1], b, 1e-3, 60, corr=corr))
        x, rep = fn(A, jnp.asarray(G), y)
        outs[corr] = (np.asarray(x), int(rep.iter))
    x0, it0 = outs["gram"]
    for corr in ("sparse", "dense"):
        xc, itc = outs[corr]
        assert itc == it0, (corr, itc, it0)
        np.testing.assert_allclose(xc, x0, atol=2e-4, err_msg=corr)


def test_corr_routing():
    """The api routes corr by the batch·k_max < 2m crossover and
    gram=True pins the Gram form (explain's contract)."""
    A, _, _ = _problem(64, 256, 4, seed=31)
    auto = ss.Omp(A, engine="jax")
    assert auto.explain(max_iterations=10)["corr"] == "gram"
    assert auto.explain(batch=100, max_iterations=20)["corr"] == "dense"
    nog = ss.Omp(A, engine="jax", gram=False)
    assert nog.explain(max_iterations=10)["corr"] == "sparse"
    assert nog.explain(batch=100, max_iterations=20)["corr"] == "dense"
    forced = ss.Omp(A, engine="jax", gram=True)
    assert forced.explain(batch=100, max_iterations=20)["corr"] == "gram"


def test_fuzz_engine_parity():
    """Randomized sweep: the native C++ engine and the jax engine run
    the identical greedy algorithm (leftmost pick, online-inverse LS,
    true residual), so across random shapes/sparsities their pick
    counts must agree and solutions match at the reference property
    tolerance. Forks are allowed only on near-tie picks (competing
    correlations within fp noise), which the unit-norm well-conditioned
    draws here make rare."""
    if not native.available():
        pytest.skip("native backend unavailable")
    rng = np.random.RandomState(321)
    forks = 0
    trials = 20
    for t in range(trials):
        m = int(rng.choice([24, 48, 96]))
        n = int(rng.choice([16, 64, 160]))
        k = int(rng.randint(1, max(2, min(m, n) // 6)))
        A = rng.randn(m, n).astype(np.float32)
        A /= np.linalg.norm(A, axis=0)
        x_true = np.zeros(n, np.float32)
        x_true[rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1.0, k)
        y = (A @ x_true).astype(np.float32)
        xn, itn, errn = native.omp_solve(A, y, 1e-3, 80, 80)
        xj, repj = ss.Omp(A, engine="jax").solve(
            y, tolerance=1e-3, max_iterations=80)
        if itn != repj.iter:
            forks += 1  # fp near-tie pick fork: require both recovered
            assert errn <= 1e-3 and repj.solution_error <= 1e-3, \
                (t, m, n, k)
            continue
        np.testing.assert_allclose(xn, xj, atol=5e-4,
                                   err_msg=f"trial {t} {m}x{n} k={k}")
    assert forks <= trials // 7, f"{forks}/{trials} pick forks"


def test_batch_driver_matches_vmapped_core(monkeypatch):
    """The slot-space batch driver (solvers/omp_batch.py — q product +
    in-place insert/LS) visits the same
    picks and solutions as the vmapped core, and the api routes to it
    under SS_BATCH_NATIVE=1."""
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    rng = np.random.RandomState(33)
    A = rng.randn(96, 256).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = []
    for _ in range(6):  # signals all from THIS A (per-lane supports)
        x = np.zeros(256, np.float32)
        x[rng.choice(256, 7, replace=False)] = rng.uniform(0.5, 1.0, 7)
        Y.append(A @ x)
    Y = np.stack(Y)
    solver = ss.Omp(A, engine="jax")
    plan = solver.explain(batch=6, max_iterations=30)
    assert plan["corr"] == "driver", plan
    # tol 1e-2 keeps tol² far above the rss rounding floor so the two
    # formulations stop identically (see the module docstring)
    X, reps = solver.solve_batch(Y, tolerance=1e-2, max_iterations=30)
    monkeypatch.setenv("SS_BATCH_NATIVE", "0")
    core = ss.Omp(A, engine="jax")
    assert core.explain(batch=6, max_iterations=30)["corr"] != "driver"
    Xc, repsc = core.solve_batch(Y, tolerance=1e-2, max_iterations=30)
    np.testing.assert_array_equal(np.asarray(reps.iter),
                                  np.asarray(repsc.iter))
    np.testing.assert_allclose(np.asarray(X), np.asarray(Xc), atol=2e-4)
    # the driver's reported error is the high-precision certificate
    assert np.asarray(reps.solution_error).max() <= 1e-2


def test_batch_driver_degenerate_duplicates(monkeypatch):
    """Driver lanes on a rank-deficient dictionary break finitely with
    the previous LS solution intact (the omp_insert kernel's guard)."""
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    rng = np.random.RandomState(8)
    base = rng.randn(24, 6).astype(np.float32)
    A = np.concatenate([base] * 8, axis=1)
    A /= np.linalg.norm(A, axis=0)
    Y = np.stack([
        (A[:, :3] @ rng.uniform(0.5, 1, 3).astype(np.float32))
        for _ in range(4)])
    solver = ss.Omp(A, engine="jax")
    X, reps = solver.solve_batch(Y, tolerance=1e-7, max_iterations=40)
    X = np.asarray(X)
    assert np.isfinite(X).all()
    assert np.isfinite(np.asarray(reps.solution_error)).all()
    assert (np.asarray(reps.iter) <= 7).all()


def test_batch_driver_compact_output(monkeypatch):
    """solve_batch(dense=False) returns the driver's slot-space
    (values, indices) that densify to the dense result exactly; the
    vmapped-core and native routes provide the same compact surface."""
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    rng = np.random.RandomState(44)
    A = rng.randn(96, 256).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = []
    for _ in range(5):
        x = np.zeros(256, np.float32)
        x[rng.choice(256, 6, replace=False)] = rng.uniform(0.5, 1.0, 6)
        Y.append(A @ x)
    Y = np.stack(Y)
    solver = ss.Omp(A, engine="jax")
    assert solver.explain(batch=5, max_iterations=20)["corr"] == "driver"
    X, rep = solver.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    v, ix, repc = solver.solve_batch(Y, tolerance=1e-2,
                                     max_iterations=20, dense=False)
    np.testing.assert_array_equal(np.asarray(rep.iter),
                                  np.asarray(repc.iter))
    np.testing.assert_allclose(
        np.asarray(ss.densify_batch(v, ix, 256)), np.asarray(X), atol=0)
    assert np.asarray(ix).shape[1] <= 20
    # vmapped-core route (driver forbidden)
    monkeypatch.setenv("SS_BATCH_NATIVE", "0")
    core = ss.Omp(A, engine="jax")
    Xc, repx = core.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    v2, i2, rep2 = core.solve_batch(Y, tolerance=1e-2,
                                    max_iterations=20, dense=False)
    np.testing.assert_array_equal(np.asarray(repx.iter),
                                  np.asarray(rep2.iter))
    np.testing.assert_allclose(
        np.asarray(ss.densify_batch(v2, i2, 256)), np.asarray(Xc), atol=0)
    # native route
    nat = ss.Omp(A, engine="native")
    Xn, repn = nat.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    v3, i3, rep3 = nat.solve_batch(Y, tolerance=1e-2,
                                   max_iterations=20, dense=False)
    np.testing.assert_allclose(
        np.asarray(ss.densify_batch(v3, i3, 256)), np.asarray(Xn), atol=0)


def test_batch_driver_gram_free(monkeypatch):
    """The gram-free batch driver (Omp(A, gram=False) on the driver
    route — on-the-fly insert columns, no n² table) matches the
    gram-enabled driver pick-for-pick and solution-for-solution."""
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    rng = np.random.RandomState(55)
    A = rng.randn(96, 256).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = []
    for _ in range(6):
        x = np.zeros(256, np.float32)
        x[rng.choice(256, 7, replace=False)] = rng.uniform(0.5, 1.0, 7)
        Y.append(A @ x)
    Y = np.stack(Y)
    # formulation parity is asserted at "high" path precision: the
    # round-5 "certified" default runs picks at one-pass precision,
    # where the gram-free bf16 insert columns vs the f32 Gram table are
    # a documented ulp-divergence class (certified behavior has its own
    # tests)
    free = ss.Omp(A, engine="jax", gram=False, precision="high")
    plan = free.explain(batch=6, max_iterations=30)
    assert plan["corr"] == "driver" and plan["gram_free"], plan
    Xf, rf = free.solve_batch(Y, tolerance=1e-2, max_iterations=30)
    gram = ss.Omp(A, engine="jax", precision="high")
    Xg, rg = gram.solve_batch(Y, tolerance=1e-2, max_iterations=30)
    np.testing.assert_array_equal(np.asarray(rf.iter), np.asarray(rg.iter))
    np.testing.assert_allclose(np.asarray(Xf), np.asarray(Xg), atol=2e-4)
    assert np.asarray(rf.solution_error).max() <= 1e-2


def test_gram_pin_beats_driver_routing(monkeypatch):
    """gram=True pins the Gram-gather vmapped formulation (the
    documented contract) — the batch driver must not override it, even
    under SS_BATCH_NATIVE=1 (review finding)."""
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    rng = np.random.RandomState(3)
    A = rng.randn(64, 256).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    pinned = ss.Omp(A, engine="jax", gram=True)
    plan = pinned.explain(batch=100, max_iterations=20)
    assert plan["corr"] == "gram", plan
    # unpinned (auto gram) still routes to the driver
    auto = ss.Omp(A, engine="jax")
    assert auto.explain(batch=100, max_iterations=20)["corr"] == "driver"


def test_batch_driver_honors_highest_precision(monkeypatch):
    """precision='highest' is not downgraded by the driver: its C0/
    certificate scopes resolve to 'highest' (review finding), and the
    trajectory matches the vmapped core at highest pick-for-pick."""
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    rng = np.random.RandomState(9)
    A = rng.randn(96, 256).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = []
    for _ in range(4):
        x = np.zeros(256, np.float32)
        x[rng.choice(256, 6, replace=False)] = rng.uniform(0.5, 1.0, 6)
        Y.append(A @ x)
    Y = np.stack(Y)
    hi = ss.Omp(A, engine="jax", precision="highest")
    assert hi.explain(batch=4, max_iterations=20)["corr"] == "driver"
    X, rep = hi.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    monkeypatch.setenv("SS_BATCH_NATIVE", "0")
    core = ss.Omp(A, engine="jax", precision="highest")
    Xc, repc = core.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    np.testing.assert_array_equal(np.asarray(rep.iter),
                                  np.asarray(repc.iter))
    np.testing.assert_allclose(np.asarray(X), np.asarray(Xc), atol=1e-5)


def test_certified_precision(monkeypatch):
    """precision='certified' (homotopy's design on the ℓ₂ criterion):
    the pick loop runs at one-pass precision, the reported error is the
    high-precision residual certificate, failing lanes re-solve at
    'high' in solve/solve_batch, and exact mode rejects it."""
    rng = np.random.RandomState(71)
    A = rng.randn(96, 256).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = []
    for _ in range(5):
        x = np.zeros(256, np.float32)
        x[rng.choice(256, 6, replace=False)] = rng.uniform(0.5, 1.0, 6)
        Y.append(A @ x)
    Y = np.stack(Y)

    with pytest.raises(ValueError, match="certified"):
        ss.Omp(A, mode="exact", precision="certified")

    # driver route: the certificate is built in
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    cert = ss.Omp(A, engine="jax", precision="certified")
    plan = cert.explain(batch=5, max_iterations=20)
    assert plan["corr"] == "driver" and plan["path_precision"] == "default"
    X, rep = cert.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    errs = np.asarray(rep.solution_error)
    resid = np.linalg.norm(Y - np.asarray(X) @ A.T, axis=1)
    np.testing.assert_allclose(errs, resid, rtol=1e-4, atol=1e-6)
    assert (errs <= 1e-2).all()

    # vmapped route: the certificate wrapper recomputes the error
    monkeypatch.setenv("SS_BATCH_NATIVE", "0")
    cert2 = ss.Omp(A, engine="jax", precision="certified")
    assert cert2.explain(batch=5, max_iterations=20)["corr"] != "driver"
    X2, rep2 = cert2.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    errs2 = np.asarray(rep2.solution_error)
    resid2 = np.linalg.norm(Y - np.asarray(X2) @ A.T, axis=1)
    np.testing.assert_allclose(errs2, resid2, rtol=1e-4, atol=1e-6)
    assert (errs2 <= 1e-2).all()

    # single solve + compact output compose with certified
    x1, r1 = cert2.solve(Y[0], tolerance=1e-2, max_iterations=20)
    assert r1.solution_error <= 1e-2
    v, ix, rc = cert2.solve_batch(Y, tolerance=1e-2, max_iterations=20,
                                  dense=False)
    np.testing.assert_allclose(
        np.asarray(ss.densify_batch(v, ix, 256)), np.asarray(X2),
        atol=2e-4)


def test_batch_driver_capacity_ladder_exact():
    """The OMP driver's capacity-tier ladder (reduced-capacity early
    loops + zero-pad embeds) continues the identical trajectory: same
    pick counts, identical solutions vs the single-tier driver."""
    import jax.numpy as jnp
    from sparse_solvers_tpu.ops import blas
    from sparse_solvers_tpu.solvers.omp_batch import solve_omp_batch
    rng = np.random.RandomState(13)
    A = rng.randn(128, 320).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = []
    for _ in range(8):
        x = np.zeros(320, np.float32)
        x[rng.choice(320, 20, replace=False)] = rng.uniform(0.4, 1.0, 20)
        Y.append(A @ x)
    Y = jnp.asarray(np.stack(Y))
    Aj = jnp.asarray(A)
    G = blas.xgemm(Aj, Aj, trans_a=True)
    X1, r1 = solve_omp_batch(Aj, G, Y, 1e-2, 30, 30,
                             ladder=False)
    X2, r2 = solve_omp_batch(Aj, G, Y, 1e-2, 30, 30,
                             ladder=True)
    np.testing.assert_array_equal(np.asarray(r1.iter), np.asarray(r2.iter))
    np.testing.assert_array_equal(np.asarray(X1), np.asarray(X2))
    np.testing.assert_array_equal(np.asarray(r1.solution_error),
                                  np.asarray(r2.solution_error))
    # gram-free ladder too
    Xf1, rf1 = solve_omp_batch(Aj, None, Y, 1e-2, 30, 30,
                               ladder=False)
    Xf2, rf2 = solve_omp_batch(Aj, None, Y, 1e-2, 30, 30,
                               ladder=True)
    np.testing.assert_array_equal(np.asarray(rf1.iter),
                                  np.asarray(rf2.iter))
    np.testing.assert_array_equal(np.asarray(Xf1), np.asarray(Xf2))


def test_certified_resolve_merge(monkeypatch):
    """Force a certificate failure through the _certified_l2_error seam
    and verify the re-solve merge: the failing lane's solution/report
    come from the 'high' re-solve, other lanes keep the certified run
    (dense and compact legs)."""
    import jax.numpy as jnp
    from sparse_solvers_tpu import api as _api
    monkeypatch.setenv("SS_BATCH_NATIVE", "0")  # vmapped route (the
    # wrapper with the seam); the driver fuses its own certificate
    rng = np.random.RandomState(77)
    A = rng.randn(96, 256).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = []
    for _ in range(4):
        x = np.zeros(256, np.float32)
        x[rng.choice(256, 5, replace=False)] = rng.uniform(0.5, 1.0, 5)
        Y.append(A @ x)
    Y = np.stack(Y)

    real = _api._certified_l2_error

    def spoofed(Aj, X, Yj):
        err = real(Aj, X, Yj)
        if err.ndim == 1:  # batched: lane 0 "fails" its certificate
            err = err.at[0].add(jnp.asarray(1.0, err.dtype))
        return err

    monkeypatch.setattr(_api, "_certified_l2_error", spoofed)
    cert = ss.Omp(A, engine="jax", precision="certified")
    X, rep = cert.solve_batch(Y, tolerance=1e-2, max_iterations=20)
    v, ix, repc = cert.solve_batch(Y, tolerance=1e-2, max_iterations=20,
                                   dense=False)
    monkeypatch.setattr(_api, "_certified_l2_error", real)
    hi = ss.Omp(A, engine="jax", precision="high")
    Xh, reph = hi.solve_batch(Y, tolerance=1e-2, max_iterations=20)

    # lane 0 was re-solved at "high": exact match with the high run
    np.testing.assert_array_equal(np.asarray(X)[0], np.asarray(Xh)[0])
    assert int(np.asarray(rep.iter)[0]) == int(np.asarray(reph.iter)[0])
    # its merged error is the high run's (un-spoofed) residual
    assert float(np.asarray(rep.solution_error)[0]) <= 1e-2
    # other lanes keep the certified run's (spoof-free) results
    assert (np.asarray(rep.solution_error)[1:] <= 1e-2).all()
    # compact leg merged identically
    np.testing.assert_array_equal(
        np.asarray(ss.densify_batch(v, ix, 256)), np.asarray(X))
    np.testing.assert_array_equal(np.asarray(repc.iter),
                                  np.asarray(rep.iter))


def test_fuzz_driver_vs_core(monkeypatch):
    """Randomized driver-vs-vmapped-core sweep across awkward shapes:
    unaligned n (gram_slot_gather's take_along fallback + the scan
    kernels' own padding), odd batch sizes (the insert kernel's 32-lane
    pad), small k_max capacity edges, and gram/gram-free. tol=1e-2
    keeps tol² above the rss floor so both formulations stop
    identically; near-tie pick forks are tolerated only if both sides
    recovered."""
    rng = np.random.RandomState(99)
    forks = 0
    trials = 14
    for t in range(trials):
        m = int(rng.choice([40, 64, 96]))
        n = int(rng.choice([128, 200, 256, 384]))  # 200: n % 128 != 0
        b = int(rng.choice([1, 3, 8, 33]))
        k = int(rng.randint(1, max(2, min(m, n) // 8)))
        # gram=True pins the vmapped Gram-gather formulation (documented
        # contract), so the driver fuzz draws auto (None) vs gram-free
        gram = None if rng.randint(0, 2) else False
        # round 5: half the trials fuzz the gOMP rounds too
        # (single default tier at these capacities, so driver and core
        # rounds align)
        J = int(rng.choice([1, 1, 2, 4]))
        A = rng.randn(m, n).astype(np.float32)
        A /= np.linalg.norm(A, axis=0)
        Y = np.zeros((b, m), np.float32)
        for i in range(b):
            x = np.zeros(n, np.float32)
            x[rng.choice(n, k, replace=False)] = rng.uniform(0.4, 1.0, k)
            Y[i] = A @ x
        kw = dict(tolerance=1e-2, max_iterations=30)
        monkeypatch.setenv("SS_BATCH_NATIVE", "1")
        # "high" pins the 3-pass formulation-parity regime (the
        # certified default's one-pass picks add a documented
        # bf16-divergence class between gram-free and core)
        drv = ss.Omp(A, engine="jax", gram=gram, precision="high",
                     picks=J)
        assert drv.explain(batch=b, max_iterations=30)["corr"] == "driver"
        Xd, rd = drv.solve_batch(Y, **kw)
        monkeypatch.setenv("SS_BATCH_NATIVE", "0")
        core = ss.Omp(A, engine="jax", gram=gram, precision="high",
                      picks=J)
        Xc, rc = core.solve_batch(Y, **kw)
        same = np.asarray(rd.iter) == np.asarray(rc.iter)
        if not same.all():
            forks += 1  # fp near-tie fork: both sides must still be good
            ed = np.asarray(rd.solution_error)
            ec = np.asarray(rc.solution_error)
            assert (ed <= 1e-2).all() and (ec <= 1e-2).all(), (t, m, n, b)
            continue
        np.testing.assert_allclose(np.asarray(Xd), np.asarray(Xc),
                                   atol=5e-4,
                                   err_msg=f"t={t} {m}x{n} b={b} k={k} "
                                           f"gram={gram}")
        assert (np.asarray(rd.solution_error) <= 1e-2).all()
    assert forks <= trials // 5, f"{forks}/{trials} driver forks"


# ------------------------------------------------- generalized OMP (picks>1)

@pytest.mark.parametrize("m,n,k,J", [
    (48, 128, 6, 2),
    (64, 160, 9, 3),
    (64, 128, 8, 4),
])
def test_gomp_oracle_parity(m, n, k, J):
    """Generalized OMP (round 5): picks-per-round engine matches the
    dense-lstsq oracle round-for-round (same support sequence, same
    committed column count) and recovers the planted support."""
    A, x_true, y = _problem(m, n, k, seed=m + n + J)
    tol = 1e-3
    xo, ito, erro, picks_o = oracle.solve(A, y, tol, 100, picks=J)
    solver = ss.Omp(A, engine="jax", picks=J)
    x, rep = solver.solve(y, tolerance=tol, max_iterations=100)
    assert rep.iter == ito
    np.testing.assert_allclose(x, xo, atol=3e-4)
    sup = set(np.flatnonzero(x_true != 0).tolist())
    assert sup <= set(np.flatnonzero(np.abs(x) > 10 * tol).tolist())
    assert rep.solution_error <= tol


def test_gomp_fewer_rounds_same_recovery():
    """The point of gOMP: a k-sparse recovery in ~k/picks rounds of the
    expensive correlation pass, same solution quality."""
    A, x_true, y = _problem(96, 256, 12, seed=5)
    x1, r1 = ss.Omp(A, engine="jax").solve(y, tolerance=1e-3,
                                           max_iterations=60)
    x4, r4 = ss.Omp(A, engine="jax", picks=4).solve(y, tolerance=1e-3,
                                                    max_iterations=60)
    sup = set(np.flatnonzero(x_true != 0).tolist())
    for x in (x1, x4):
        assert sup <= set(np.flatnonzero(np.abs(x) > 1e-2).tolist())
    np.testing.assert_allclose(x4, x1, atol=5e-3)  # extra ~0 coeffs ok


def test_gomp_batch_and_mesh(mesh_or_skip=None):
    import jax
    A, x_true, y = _problem(64, 256, 8, seed=7)
    Y = np.stack([_problem(64, 256, 8, seed=s)[2] for s in range(4)])
    solver = ss.Omp(A, engine="jax", picks=3)
    X, reps = solver.solve_batch(Y, tolerance=1e-3, max_iterations=40)
    for b in range(4):
        xb, repb = solver.solve(Y[b], tolerance=1e-3, max_iterations=40)
        assert int(np.asarray(reps.iter)[b]) == repb.iter
        np.testing.assert_allclose(np.asarray(X)[b], xb, atol=3e-4)
    if jax.device_count() >= 8:
        from sparse_solvers_tpu.parallel import sharding as sh
        mesh = sh.make_mesh(n_row=4, n_data=2)
        sm = ss.Omp(A, engine="jax", picks=3, mesh=mesh)
        assert sm.explain(batch=4)["picks"] == 3
        assert not sm.explain(batch=4)["batch_native"]
        Xm, repm = sm.solve_batch(Y, tolerance=1e-3, max_iterations=40)
        np.testing.assert_array_equal(np.asarray(repm.iter),
                                      np.asarray(reps.iter))
        np.testing.assert_allclose(np.asarray(Xm), np.asarray(X),
                                   atol=1e-5)


def test_gomp_validation_and_routing():
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError):
        ss.Omp(A, picks=0)
    with pytest.raises(ValueError):
        ss.Omp(A, picks="2")
    s = ss.Omp(A, engine="jax", picks=2)
    assert s.explain(batch=64)["picks"] == 2
    # the driver DOES serve picks>1 since the gOMP rounds landed; on
    # this CPU backend route_batch_native declines for other reasons
    assert not s._route_driver(64, 8)
    with pytest.raises(ValueError, match="picks must be <= n"):
        ss.Omp(A, engine="jax", picks=9)


@pytestmark_native
@pytest.mark.parametrize("J,dtype", [(2, np.float32), (4, np.float32),
                                     (3, np.float64)])
def test_gomp_native_matches_oracle_and_jax(J, dtype):
    """The native twin's generalized-OMP rounds (ss_omp_solve_pk_*)
    match the oracle and the jax engine round-for-round, f32 + f64,
    single and threaded batch."""
    A, x_true, y = _problem(64, 128, 8, seed=J, dtype=dtype)
    tol = _tol(dtype)
    xo, ito, erro, _ = oracle.solve(A, y, tol, 100, picks=J)
    xn, itn, errn = native.omp_solve(A, y, tol, 100, 100, picks=J)
    xj, repj = ss.Omp(A, engine="jax", picks=J).solve(
        y, tolerance=tol, max_iterations=100)
    assert itn == ito == repj.iter
    np.testing.assert_allclose(xn, xo, atol=3e-4)
    np.testing.assert_allclose(xn, xj, atol=3e-4)
    # threaded batch bit-equal to sequential pk solves
    Y = np.stack([_problem(64, 128, 8, seed=s_)[2].astype(dtype)
                  for s_ in range(5)])
    X, iters, errs = native.omp_solve_batch(A, Y, tol, 50, 50, picks=J)
    for b in range(5):
        xb, itb, errb = native.omp_solve(A, Y[b], tol, 50, 50, picks=J)
        assert iters[b] == itb and errs[b] == errb
        np.testing.assert_array_equal(X[b], xb)
    # the auto engine routes small gOMP problems to the native twin
    small = ss.Omp(A, picks=J) if dtype == np.float32 else None
    if small is not None:
        assert small.explain()["engine"] == "native"
        xa, ra = small.solve(y, tolerance=tol, max_iterations=100)
        assert ra.iter == ito


def test_gomp_batch_driver_matches_core(monkeypatch):
    """The slot-space driver's gOMP rounds (round 5: J guarded
    insert-kernel calls per fused q pass) match the vmapped gOMP core
    round-for-round at the convention tolerance regime (tol=1e-2 keeps
    tol² above the rss identity floor)."""
    rng = np.random.RandomState(77)
    m, n, k, b = 96, 256, 8, 6
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X0 = np.zeros((b, n), np.float32)
    for i in range(b):
        X0[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1, k)
    Y = (X0 @ A.T).astype(np.float32)
    for J in (2, 4, 8):
        monkeypatch.setenv("SS_BATCH_NATIVE", "1")
        drv = ss.Omp(A, engine="jax", picks=J, precision="high")
        assert drv.explain(batch=b, max_iterations=30)["corr"] == "driver"
        Xd, rd = drv.solve_batch(Y, tolerance=1e-2, max_iterations=30)
        monkeypatch.setenv("SS_BATCH_NATIVE", "0")
        core = ss.Omp(A, engine="jax", picks=J, precision="high")
        Xc, rc = core.solve_batch(Y, tolerance=1e-2, max_iterations=30)
        np.testing.assert_array_equal(np.asarray(rd.iter),
                                      np.asarray(rc.iter))
        np.testing.assert_allclose(np.asarray(Xd), np.asarray(Xc),
                                   atol=5e-4)
        for i in range(b):
            got = set(np.flatnonzero(np.abs(np.asarray(Xd)[i]) > 1e-2))
            assert got >= set(np.flatnonzero(X0[i])), (J, i)


def test_gomp_zero_correlation_round_matches_oracle():
    """Review regression (round 5): gOMP sub-inserts must require a
    strictly positive correlation (the oracle's degenerate guard) — a
    zero-correlation column admitted into a round forked engine/oracle
    supports. Orthonormal columns with a 3-sparse signal: picks=4's
    first round must commit exactly 3 columns on every route."""
    A = np.eye(16, dtype=np.float32)[:, :8]
    y = np.zeros(16, np.float32)
    y[[0, 2, 5]] = [1.0, -0.5, 0.25]
    xo, ito, erro, so = oracle.solve(A, y, 1e-6, 20, picks=4)
    assert ito == 3 and sorted(so) == [0, 2, 5]
    xj, repj = ss.Omp(A, engine="jax", picks=4).solve(
        y, tolerance=1e-6, max_iterations=20)
    assert repj.iter == 3
    if native.available():
        xn, itn, errn = native.omp_solve(A, y, 1e-6, 20, 20, picks=4)
        assert itn == 3
        np.testing.assert_allclose(xn, xo, atol=1e-6)
    from sparse_solvers_tpu.solvers.omp_batch import solve_omp_batch
    import jax.numpy as jnp
    Xd, rd = solve_omp_batch(jnp.asarray(A), None, jnp.asarray(y[None]),
                             1e-6, 20, 8, picks=4)
    assert int(np.asarray(rd.iter)[0]) == 3
