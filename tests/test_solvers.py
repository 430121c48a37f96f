"""Solver property tests — port of the reference's generic solver harness
(reference: src/solvers/test_util.h) with its per-solver report checks
(homotopy_test.cpp:8-22, irls_test.cpp:8-23), run for float32 AND float64
like the reference's dual-dtype test matrix.

Fixtures:
  smoke_test            test_util.h:27-55   — A=I, one-hot → exact recovery
  smoke_column_subset   test_util.h:57-92   — non-contiguous column view
  noisy_signal_test     test_util.h:94-126  — A=I₅₀ + uniform noise
  noisy_patterns_test   test_util.h:136-197 — planted pattern in gaussian
                                              haystack (homotopy only)
  permutations_test     test_util.h:204-257 — permutation columns + noise
"""

import itertools

import numpy as np
import pytest

import sparse_solvers_tpu as ss

DTYPES = [np.float32, np.float64]


def check_homotopy_report(report, tolerance, max_iterations):
    # homotopy_test.cpp:8-22
    assert report.iter >= 1
    assert report.iter <= max_iterations
    if report.iter < max_iterations:
        assert report.solution_error <= tolerance


def check_irls_report(report, tolerance, max_iterations):
    # irls_test.cpp:8-23
    assert report.iter >= 1
    assert report.iter <= max_iterations
    if report.iter < max_iterations and not report.spd_failure:
        assert report.solution_error <= tolerance


SOLVERS = {
    "homotopy": (ss.Homotopy, check_homotopy_report),
    "irls": (ss.Irls, check_irls_report),
}


@pytest.mark.parametrize("name", SOLVERS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_smoke(name, dtype):
    """A = I₅; recovery must be exact (test_util.h:27-55)."""
    Solver, check = SOLVERS[name]
    N = 5
    A = np.identity(N, dtype=dtype)
    solver = Solver(A)
    for n in range(N):
        signal = np.zeros(N, dtype=dtype)
        signal[n] = 1
        x, report = solver.solve(signal, tolerance=0.001, max_iterations=N)
        check(report, 0.001, N)
        np.testing.assert_array_equal(x, signal)


@pytest.mark.parametrize("name", SOLVERS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_smoke_column_subset(name, dtype):
    """Solver consumes a non-contiguous column view (test_util.h:57-92)."""
    Solver, check = SOLVERS[name]
    N, M = 10, 5
    rng = np.random.RandomState(0)
    data = np.zeros((M, N), dtype=dtype)
    data[:, : M - 1] = rng.uniform(0.0, 0.1, (M, M - 1))
    data[:, M:N] = np.identity(M)
    identity_view = data[:, M:N]  # non-contiguous view

    solver = Solver(identity_view)
    for n in range(M):
        signal = identity_view[:, n].copy()
        x, report = solver.solve(signal, tolerance=0.001, max_iterations=N)
        np.testing.assert_array_equal(x, signal)


@pytest.mark.parametrize("name", SOLVERS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_noisy_signal(name, dtype):
    """A=I₅₀, one-hot + U(0, noise); exactly one x element above the noise
    level (test_util.h:94-126)."""
    Solver, check = SOLVERS[name]
    N, NOISE = 50, 0.01
    rng = np.random.RandomState(0)
    A = np.identity(N, dtype=dtype)
    solver = Solver(A)
    for n in range(N):
        signal = rng.uniform(0.0, NOISE, N).astype(dtype)
        signal[n] += 1 - 0.5 * NOISE
        x, report = solver.solve(signal, tolerance=NOISE, max_iterations=N)
        check(report, NOISE, N)
        assert np.sum(x > NOISE) == 1


def _noisy_patterns_case(dtype, M, N, noise_level, signal_level, rng):
    """One column's worth of the noisy_patterns fixture
    (test_util.h:136-197)."""
    PATTERN = 2
    noise = rng.normal(0.5, noise_level, (M, N)).astype(dtype)
    signal = rng.normal(0.5, noise_level, M).astype(dtype)
    signal[0:M:PATTERN] += signal_level
    signal = signal / np.sum(np.abs(signal))
    return noise, signal, PATTERN


@pytest.mark.parametrize("shape", [(100, 25), (25, 100)])
def test_noisy_patterns_homotopy(shape):
    """Planted-needle search (homotopy only, float32), with reconstruction
    check (test_util.h:136-197, homotopy_test.cpp:41-45)."""
    dtype = np.float32
    M, N = shape
    noise_level, signal_level = 0.1, 1.0
    ERROR = 0.1 * noise_level
    rng = np.random.RandomState(0)
    noise, signal, PATTERN = _noisy_patterns_case(
        dtype, M, N, noise_level, signal_level, rng)

    # subsample columns to keep runtime sane; the reference sweeps all N
    for n in range(0, N, max(1, N // 8)):
        haystack = noise.copy()
        haystack[0:M:PATTERN, n] = signal_level
        haystack = ss.norm_l1(haystack).astype(dtype)

        x, report = ss.Homotopy(haystack).solve(
            signal, tolerance=ERROR, max_iterations=N)
        check_homotopy_report(report, ERROR, N)

        assert np.argmax(x) == n
        assert np.sum(x > ERROR) == 1

        y = ss.reconstruct_signal(haystack, x)
        np.testing.assert_allclose(y, signal, rtol=0, atol=5 * ERROR)


def _permutation_matrix(M, N, signal_noise, sensing_noise, skip, dtype, rng):
    """Columns are successive permutations of 1..M plus gaussian noise
    (test_util.h:204-257)."""
    col = np.arange(1, M + 1, dtype=np.float64)
    perms = []
    it = itertools.permutations(range(M))
    # emulate std::next_permutation chains: generate enough permutations
    # lazily and step through them `skip` at a time
    seq = list(itertools.islice(it, 0, (N + 1) * skip + 1))

    def perm_at(i):
        p = seq[min(i, len(seq) - 1)]
        return np.array([col[j] for j in p])

    A = rng.normal(0.0, sensing_noise, (M, N)).astype(np.float64)
    cols = []
    for n in range(N):
        c = perm_at((n + 1) * skip)
        cols.append(c)
        A[:, n] += c
    return A.astype(dtype), [c.astype(np.float64) for c in cols]


@pytest.mark.parametrize("name,cases", [
    ("homotopy", [(10, 10, 0.1, 0.1, 10), (25, 10, 0.1, 0.1, 50),
                  (10, 25, 0.05, 0.05, 50)]),   # homotopy_test.cpp:47-61
    ("irls", [(5, 5, 0.1, 0.1, 10), (10, 5, 0.1, 0.1, 10)]),  # irls_test.cpp:43-54
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_permutations(name, cases, dtype):
    Solver, check = SOLVERS[name]
    rng = np.random.RandomState(0)
    for (M, N, signal_noise, sensing_noise, skip) in cases:
        ERROR = signal_noise + sensing_noise
        A, cols = _permutation_matrix(
            M, N, signal_noise, sensing_noise, skip, dtype, rng)
        solver = Solver(A)
        for n in range(N):
            signal = (cols[n] + rng.normal(0.0, signal_noise, M)).astype(dtype)
            x, report = solver.solve(signal, tolerance=ERROR,
                                     max_iterations=N)
            check(report, ERROR, N)
            assert np.argmax(x) == n, (
                f"{name} {M}x{N} {dtype.__name__}: argmax {np.argmax(x)} != {n}"
            )


def test_ill_conditioned_f32_wanders_f64_exact():
    """A near-degenerate 2-sparse problem where float32 path-following
    wanders (both here and in a float32 oracle — inherent to the
    algorithm, reference runs the same risk in its f32 instantiation)
    while float64 recovers the support in exactly 2 path segments,
    matching the float64 oracle's iteration count and error."""
    import sparse_solvers_tpu as ss

    rng = np.random.RandomState(0)
    m, n = 35, 24
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    x_true = np.zeros(n, np.float32)
    x_true[[7, 11]] = 1.0
    y = x_true @ A.T

    x64, rep64 = ss.Homotopy(A.astype(np.float64), engine="jax").solve(
        y.astype(np.float64), tolerance=0.01, max_iterations=100)
    assert rep64.iter == 2
    assert sorted(np.nonzero(np.round(x64, 3))[0]) == [7, 11]
    np.testing.assert_allclose(x64, x_true, atol=1e-6)

    # f32 must still terminate and satisfy the tolerance, support aside
    x32, rep32 = ss.Homotopy(A, engine="jax").solve(
        y, tolerance=0.01, max_iterations=100)
    assert rep32.solution_error <= 0.01
    assert np.isfinite(x32).all()


def test_irls_fast_exact_mode_parity():
    """The collapsed Newton step (QᵀQ=I) must match the reference-shaped
    dense step on recoverable problems (solvers/irls.py:_newton_fast)."""
    import sparse_solvers_tpu as ss

    rng = np.random.RandomState(9)
    m, n = 80, 40
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    x_true = np.zeros(n, np.float32)
    x_true[13] = 1.0
    y = A @ x_true

    xe, re_ = ss.Irls(A, engine="jax", mode="exact").solve(
        y, tolerance=1e-3, max_iterations=50)
    xf, rf = ss.Irls(A, engine="jax", mode="fast").solve(
        y, tolerance=1e-3, max_iterations=50)
    assert re_.iter == rf.iter
    assert re_.spd_failure == rf.spd_failure
    np.testing.assert_allclose(xe, xf, atol=1e-5)


def test_k_max_overflow_breaks_cleanly():
    """A user-shrunk active-set capacity must terminate the path at the
    capacity (like the reference's K==0 break) rather than writing out of
    bounds and looping to max_iterations on corrupted state."""
    import sparse_solvers_tpu as ss

    rng = np.random.RandomState(0)
    m, n = 30, 60
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    xt = np.zeros(n, np.float32)
    xt[rng.choice(n, 10, replace=False)] = 1.0
    y = A @ xt

    x, rep = ss.Homotopy(A, k_max=4, engine="jax").solve(
        y, tolerance=0.01, max_iterations=50)
    assert rep.iter <= 5          # breaks at capacity, not max_iterations
    assert np.isfinite(x).all()
    assert np.isfinite(rep.solution_error)


def test_irls_spd_boundary_parity_fast_vs_exact():
    """Fast mode's spd criterion (min(w) <= eps^2, the algebraic analog of
    a Cholesky pivot failure on diag(w)) must trip at the same iteration
    as exact mode's actual Cholesky breakdown (irls-cpu.cpp:50-51,95-97).

    Geometrically-decaying coefficients with a tiny tolerance ratchet eps
    down until the weight spread breaks the weighted Gram's positive
    definiteness; across decay scales both modes flag spd_failure at the
    same iteration with matching eps. (At still-steeper decays the modes
    legitimately part ways: exact mode's thresholding can reach the
    x2 <= abstol exit one step before the collapsed step's weight check —
    the boundary itself, not a parity bug.)
    """
    import jax

    rng = np.random.RandomState(0)
    m, n = 60, 30
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Q, R = np.linalg.qr(A)
    Q = Q.astype(np.float32)
    R = R.astype(np.float32)
    from sparse_solvers_tpu.solvers import irls as IR

    for decay in [1.0, 0.3, 0.1]:
        xt = np.zeros(n, np.float32)
        xt[:8] = decay ** np.arange(8)
        y = (A @ xt).astype(np.float32)
        reps = {}
        for mode in ["fast", "exact"]:
            _, rep = jax.jit(
                lambda q, r, yy, mode=mode: IR.solve_irls(
                    q, r, yy, 1e-7, 100, mode=mode))(Q, R, y)
            reps[mode] = rep
        assert bool(reps["fast"].spd_failure), decay
        assert bool(reps["exact"].spd_failure), decay
        assert int(reps["fast"].iter) == int(reps["exact"].iter), decay
        np.testing.assert_allclose(float(reps["fast"].solution_error),
                                   float(reps["exact"].solution_error),
                                   rtol=1e-5)


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_homotopy_precision_levels_recover(precision):
    """Every matmul precision level must recover the planted support on the
    standard compressive ensemble (the headline workload in miniature).

    precision="default" (TF32 on the GPU) is the documented opt-in
    throughput mode; the contract is not
    trajectory parity with "high" — fp schedules legitimately fork — but
    oracle-quality recovery: exact support, faithful reconstruction.
    """
    import sparse_solvers_tpu as ss

    rng = np.random.RandomState(7)
    m, n, k, b = 64, 128, 6, 4
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Xt = np.zeros((b, n), np.float32)
    for i in range(b):
        Xt[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    Y = Xt @ A.T

    solver = ss.Homotopy(A, engine="jax", precision=precision)
    X, rep = solver.solve_batch(Y, tolerance=1e-2, max_iterations=2 * k)
    X = np.asarray(X)
    for i in range(b):
        sup_true = set(np.flatnonzero(Xt[i]))
        sup_got = set(np.flatnonzero(np.abs(X[i]) > 0.1))
        assert sup_got == sup_true, (precision, i)
    err = np.max(np.abs(X @ A.T - Y))
    assert err < 5e-2, (precision, err)
