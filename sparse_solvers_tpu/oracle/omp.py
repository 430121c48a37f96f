"""NumPy oracle for Orthogonal Matching Pursuit.

Independent of the jax implementation by design (like oracle/homotopy.py):
the LS re-solve uses a dense ``np.linalg.lstsq`` on the gathered columns
every iteration, so an online-inverse bug in solvers/omp.py cannot hide —
any trajectory divergence shows up in the support sequence or residuals.
"""

from __future__ import annotations

import numpy as np


def solve(A: np.ndarray, y: np.ndarray, tolerance: float,
          max_iterations: int = 100, k_max: int | None = None,
          picks: int = 1):
    """Returns (x, iters, resid_norm, support_in_pick_order).
    ``picks`` > 1 = generalized OMP (each round inserts the picks
    largest inactive correlations — solvers/omp.py)."""
    A = np.asarray(A)
    y = np.asarray(y)
    m, n = A.shape
    if k_max is None:
        k_max = max(1, min(max_iterations, m, n))

    support: list[int] = []
    coef = np.zeros(0, A.dtype)
    r = y.copy()
    rnorm = float(np.linalg.norm(r))
    it = 0
    while (it < max_iterations and len(support) < k_max
           and rnorm > tolerance):
        it += 1
        # greedy pick over the inactive set: mask actives with -inf (a 0
        # mask could re-pick an active column when every inactive
        # correlation is exactly 0, duplicating the support index so the
        # final fancy-index scatter drops a coefficient)
        ac = np.abs(A.T @ r)
        ac[support] = -np.inf
        # descending |c| with leftmost tie-break (stable argsort of
        # the negated scores == lax.top_k's ordering)
        order = np.argsort(-ac, kind="stable")[:picks]
        budget = min(max_iterations - it + 1, k_max - len(support))
        news = [int(j) for j in order if ac[j] > 0][:budget]
        if not news:
            it -= 1  # degenerate round: discarded wholesale, like the
            break    # engines' deg guard (solvers/omp.py)
        it += len(news) - 1  # the while header already counted one
        support.extend(news)
        cols = A[:, support]
        coef, *_ = np.linalg.lstsq(cols, y, rcond=None)
        r = y - cols @ coef
        rnext = float(np.linalg.norm(r))
        if rnext >= rnorm:
            # rss stall at the rounding floor — stop with the iterate
            # kept (the engines' done guard, solvers/omp.py:208)
            rnorm = rnext
            break
        rnorm = rnext

    x = np.zeros(n, A.dtype)
    x[support] = coef
    return x, it, float(np.linalg.norm(r)), support
