"""Batched (vmap) solve tests — the vmapped throughput path
(BASELINE.json config 4: many signals sharing one A). Each vmap lane carries
its own active-set state and converges independently; results must match the
sequential per-signal solves exactly.
"""

import numpy as np
import pytest

import sparse_solvers_tpu as ss


def _problem(rng, m, n, batch, k):
    A = rng.randn(m, n)
    A = A / np.abs(A).sum(axis=0)
    Y = []
    for _ in range(batch):
        x_true = np.zeros(n)
        support = rng.choice(n, k, replace=False)
        x_true[support] = rng.uniform(0.2, 1.0, k)
        Y.append(A @ x_true)
    return A, np.stack(Y)


@pytest.mark.parametrize("SolverName", ["homotopy", "irls"])
def test_batch_matches_sequential(SolverName):
    rng = np.random.RandomState(5)
    m, n, batch, k = 40, 25, 6, 3
    A, Y = _problem(rng, m, n, batch, k)
    A = A.astype(np.float64)
    Y = Y.astype(np.float64)

    Solver = ss.Homotopy if SolverName == "homotopy" else ss.Irls
    solver = Solver(A)
    # Homotopy lanes are bit-stable under vmap; IRLS amplifies the benign
    # gemv-vs-batched-gemm accumulation-order difference through its
    # near-singular weighted Cholesky, so it gets the reference's 1e-4
    # property-test tolerance instead.
    atol = 1e-12 if SolverName == "homotopy" else 1e-4

    X_batch, reports = solver.solve_batch(Y, tolerance=0.01,
                                          max_iterations=50)
    X_batch = np.asarray(X_batch)

    for b in range(batch):
        x_seq, rep_seq = solver.solve(Y[b], tolerance=0.01,
                                      max_iterations=50)
        np.testing.assert_allclose(X_batch[b], x_seq, atol=atol)
        assert int(np.asarray(reports.iter)[b]) == rep_seq.iter
        np.testing.assert_allclose(
            float(np.asarray(reports.solution_error)[b]),
            rep_seq.solution_error, atol=atol)


def test_batch_lane_divergence():
    """Lanes with different convergence speed don't contaminate each other."""
    rng = np.random.RandomState(9)
    n = 16
    A = np.identity(n) + rng.normal(0, 0.01, (n, n))
    A = A.astype(np.float64)
    # one trivially easy signal, one harder multi-support signal
    y_easy = A @ np.eye(n)[3]
    x_hard_true = np.zeros(n)
    x_hard_true[[1, 7, 12]] = [0.5, 0.3, 0.2]
    y_hard = A @ x_hard_true
    Y = np.stack([y_easy, y_hard])

    solver = ss.Homotopy(A)
    X, reports = solver.solve_batch(Y, tolerance=0.01, max_iterations=40)
    iters = np.asarray(reports.iter)
    assert iters[0] != iters[1]  # genuinely divergent lanes
    for b in range(2):
        x_seq, rep_seq = solver.solve(Y[b], tolerance=0.01,
                                      max_iterations=40)
        np.testing.assert_allclose(np.asarray(X)[b], x_seq, atol=1e-12)
        assert iters[b] == rep_seq.iter


def test_irls_batch_gemm_newton_matches_trsm(monkeypatch):
    """SS_IRLS_GEMM=1 applies the cached R⁻¹ by gemm in the batched fast
    path (opt-in alternative formulation) — algebraically identical
    to the back-substitution step; iteration counts match and solutions
    agree at the reference property tolerance (solvers/irls.py
    _newton_fast)."""
    rng = np.random.RandomState(13)
    m, n, batch, k = 60, 30, 8, 3
    A, Y = _problem(rng, m, n, batch, k)
    A, Y = A.astype(np.float32), Y.astype(np.float32)
    solver = ss.Irls(A, engine="jax")
    monkeypatch.setenv("SS_IRLS_GEMM", "1")
    assert "gemm" in solver.explain(batch=batch)["newton"]
    Xg, rg = solver.solve_batch(Y, tolerance=0.01, max_iterations=50)
    monkeypatch.setenv("SS_IRLS_GEMM", "0")
    assert "newton" not in solver.explain(batch=batch)
    Xt, rt = solver.solve_batch(Y, tolerance=0.01, max_iterations=50)
    iters = np.asarray(rg.iter)
    assert iters.max() > 1  # a fixture that actually iterates
    np.testing.assert_array_equal(iters, np.asarray(rt.iter))
    np.testing.assert_allclose(np.asarray(Xg), np.asarray(Xt), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(rg.spd_failure),
                                  np.asarray(rt.spd_failure))
