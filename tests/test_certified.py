"""Certified mixed-precision mode (precision="certified").

The path runs at one-pass precision; the final correlation
‖Aᵀ(y−Ax)‖∞ — the solver's own convergence criterion (reference:
src/solvers/homotopy-cpu.cpp:270) — is recomputed at parity-grade
precision (blas.PARITY) and reported as solution_error; solve/solve_batch
re-solve any lane whose certificate misses the tolerance at that
precision. On the CPU backend every precision setting computes identical
f32 arithmetic, so these tests pin the *machinery* (certificate values,
report plumbing, the re-solve branch and merge) — the certificate is
checked at the headline shape on the card by chip_smoke.py.
"""

import numpy as np
import pytest

import sparse_solvers_tpu as ss


def make_problem(m, n, k, batch, seed=0):
    """Unit-column gaussian compressive ensemble (bench.py workload)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((batch, n))
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        X[b, sup] = rng.uniform(0.5, 1.0, k)
    return A.astype(np.float32), (X @ A.T).astype(np.float32)


def test_certificate_is_high_precision_correlation():
    """solution_error under certified mode equals ‖Aᵀ(y−Ax)‖∞ recomputed
    from the returned solution (not the path's own running value)."""
    A, Y = make_problem(256, 512, 8, 6)
    solver = ss.Homotopy(A, precision="certified")
    X, rep = solver.solve_batch(Y, tolerance=1e-2, max_iterations=24)
    X = np.asarray(X)
    c = (Y - X @ A.T) @ A
    np.testing.assert_allclose(np.asarray(rep.solution_error),
                               np.max(np.abs(c), axis=-1),
                               rtol=1e-5, atol=1e-7)
    assert np.all(np.asarray(rep.solution_error) <= 1e-2)


def test_certified_matches_high_when_certificates_hold():
    """On CPU the one-pass path is bit-identical to "high" (precision
    flags only matter on the GPU), so certified results must equal the
    high-precision results lane-for-lane."""
    A, Y = make_problem(256, 512, 8, 6)
    cert = ss.Homotopy(A, precision="certified")
    high = ss.Homotopy(A, precision="high")
    Xc, rc = cert.solve_batch(Y, tolerance=1e-2, max_iterations=24)
    Xh, rh = high.solve_batch(Y, tolerance=1e-2, max_iterations=24)
    np.testing.assert_allclose(np.asarray(Xc), np.asarray(Xh),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(rc.iter), np.asarray(rh.iter))


def test_certified_resolve_branch_matches_high(monkeypatch):
    """Lanes whose certificate fails (including a NaN certificate — the
    NaN-safe predicate must treat it as failing) while the path claims
    convergence are re-solved at "high"; the merged lanes must carry
    exactly the high-precision results."""
    import jax.numpy as jnp
    from sparse_solvers_tpu import api as api_mod

    A, Y = make_problem(256, 512, 8, 6)
    real_cert = api_mod._certified_error

    def spoofed(Am, x, y):
        err = real_cert(Am, x, y)
        # lane 1 gets an over-tolerance certificate, lane 3 a NaN one
        return err.at[1].set(1e3).at[3].set(jnp.nan)

    monkeypatch.setattr(api_mod, "_certified_error", spoofed)
    cert = ss.Homotopy(A, precision="certified")
    Xc, rc = cert.solve_batch(Y, tolerance=1e-2, max_iterations=24)
    monkeypatch.undo()

    high = ss.Homotopy(A, precision="high")
    Xh, rh = high.solve_batch(Y, tolerance=1e-2, max_iterations=24)

    Xc, Xh = np.asarray(Xc), np.asarray(Xh)
    # spoofed-failing lanes were re-solved at high: exact match there
    for lane in (1, 3):
        np.testing.assert_array_equal(Xc[lane], Xh[lane])
        assert np.asarray(rc.solution_error)[lane] <= 1e-2
    # untouched lanes kept the fast result with a passing certificate
    assert np.all(np.asarray(rc.solution_error) <= 1e-2)
    np.testing.assert_array_equal(np.asarray(rc.iter), np.asarray(rh.iter))


def test_certified_exhausted_lanes_not_resolved():
    """A lane that exhausts max_iterations is honestly non-convergent —
    certified mode reports it as-is instead of re-solving the batch at
    "high" on every call (which would double serving cost forever)."""
    A, Y = make_problem(256, 512, 8, 4)
    tol = 1e-30  # unattainable in f32: every lane runs to max_iterations
    cert = ss.Homotopy(A, precision="certified")
    high = ss.Homotopy(A, precision="high")
    Xc, rc = cert.solve_batch(Y, tolerance=tol, max_iterations=12)
    Xh, rh = high.solve_batch(Y, tolerance=tol, max_iterations=12)
    assert np.all(np.asarray(rc.iter) == 12)
    # on CPU the one-pass path is bit-identical to high, so the
    # non-re-solved results still match lane-for-lane
    np.testing.assert_array_equal(np.asarray(rc.iter), np.asarray(rh.iter))
    np.testing.assert_allclose(np.asarray(Xc), np.asarray(Xh),
                               rtol=0, atol=0)


def test_certified_single_solve():
    A, Y = make_problem(256, 512, 4, 1)
    solver = ss.Homotopy(A, precision="certified")
    x, rep = solver.solve(Y[0], tolerance=1e-2, max_iterations=16)
    assert rep.solution_error <= 1e-2
    c = (Y[0] - np.asarray(x) @ A.T) @ A
    np.testing.assert_allclose(rep.solution_error, np.max(np.abs(c)),
                               rtol=1e-5, atol=1e-7)
    # unreachable tolerance: single-solve re-solve branch
    x2, rep2 = solver.solve(Y[0], tolerance=1e-30, max_iterations=8)
    xh, reph = ss.Homotopy(A, precision="high").solve(
        Y[0], tolerance=1e-30, max_iterations=8)
    assert rep2.iter == reph.iter
    np.testing.assert_allclose(np.asarray(x2), np.asarray(xh),
                               rtol=0, atol=0)


def test_certified_on_device_reports_certificate_without_resolve():
    """The jit-composable entry fuses the certificate into the report but
    performs no data-dependent re-solve (documented contract)."""
    import jax
    import jax.numpy as jnp

    A, Y = make_problem(256, 512, 8, 4)
    solver = ss.Homotopy(A, precision="certified")

    @jax.jit
    def serve(Y):
        X, rep = solver.solve_batch_on_device(Y, 1e-2, 24)
        return X, rep.solution_error

    X, err = serve(jnp.asarray(Y))
    assert np.all(np.asarray(err) <= 1e-2)
    c = (Y - np.asarray(X) @ A.T) @ A
    np.testing.assert_allclose(np.asarray(err), np.max(np.abs(c), axis=-1),
                               rtol=1e-5, atol=1e-7)


def test_certified_explain_fields():
    A, _ = make_problem(256, 512, 4, 1)
    plan = ss.Homotopy(A, precision="certified").explain(batch=64)
    assert plan["precision"] == "certified"
    assert plan["path_precision"] == "default"
    assert "certificate" in plan


def test_certified_validation():
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError, match="exact"):
        ss.Homotopy(A, mode="exact", precision="certified")
    with pytest.raises(ValueError, match="precision"):
        ss.Homotopy(A, precision="fastest")


def test_certified_over_batch_native_driver():
    """certified precision composed with the slot-space batch driver
    (the GPU headline path, forced here via SS_BATCH_NATIVE=1):
    certificates hold, solutions recover, capacity ladder active."""
    import os

    A, Y = make_problem(256, 512, 8, 6)
    os.environ["SS_BATCH_NATIVE"] = "1"
    try:
        solver = ss.Homotopy(A, precision="certified", k_max=48)
        plan = solver.explain(batch=Y.shape[0], max_iterations=64)
        assert plan["batch_native"]
        assert plan["capacity_tiers"] == [16, 24, 48]
        X, rep = solver.solve_batch(Y, tolerance=1e-2, max_iterations=64)
    finally:
        del os.environ["SS_BATCH_NATIVE"]
    X = np.asarray(X)
    assert np.all(np.asarray(rep.solution_error) <= 1e-2)
    c = (Y - X @ A.T) @ A
    np.testing.assert_allclose(np.asarray(rep.solution_error),
                               np.max(np.abs(c), axis=-1),
                               rtol=1e-5, atol=1e-7)


def test_certified_native_routing_is_exact_and_skipped():
    """precision="certified" with auto routing to the native engine:
    the host backend computes in exact f32 FMA arithmetic, so the solve
    proceeds normally and certification is a no-op (documented)."""
    A, Y = make_problem(64, 128, 4, 1)  # m*n below the native-auto floor
    solver = ss.Homotopy(A, precision="certified")
    assert solver.explain()["engine"] == "native"
    x, rep = solver.solve(Y[0], tolerance=1e-2, max_iterations=16)
    assert rep.solution_error <= 1e-2
    c = (Y[0] - np.asarray(x) @ A.T) @ A
    assert np.max(np.abs(c)) <= 1e-2


def test_certified_is_fast_mode_default():
    """Round-5 default flip: fast-mode Homotopy and Omp default to
    precision="certified" (measured free at the headline shape with an
    equally trustworthy reported error — BASELINE.md); exact mode keeps
    "highest". Parity: the default route's support is exact, its
    reported error is the high-precision certificate, and it matches
    the "high" route at test tolerances."""
    import sparse_solvers_tpu as ss
    A, Y = make_problem(48, 160, 5, 8, seed=11)
    for cls in (ss.Homotopy, ss.Omp):
        solver = cls(A, engine="jax")
        assert solver._precision == "certified"
        assert cls(A, mode="exact", engine="jax")._precision == "highest"
        plan = solver.explain(batch=8)
        assert plan["precision"] == "certified"
        X, rep = solver.solve_batch(Y, tolerance=1e-2, max_iterations=40)
        Xh, reph = cls(A, engine="jax", precision="high").solve_batch(
            Y, tolerance=1e-2, max_iterations=40)
        np.testing.assert_array_equal(np.asarray(rep.iter),
                                      np.asarray(reph.iter))
        np.testing.assert_allclose(np.asarray(X), np.asarray(Xh),
                                   atol=1e-5)
        assert np.all(np.asarray(rep.solution_error) <= 1e-2)
