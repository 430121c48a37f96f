"""NumPy oracle for CoSaMP (Needell–Tropp 2009).

Independent of the jax implementation by design (like oracle/omp.py):
the union LS uses a dense ``np.linalg.lstsq`` over the gathered
candidate columns, so a Gram/Cholesky bug in solvers/cosamp.py cannot
hide. Mirrors the engine's fixed-shape union variant exactly: the 2k
candidates are the 2k largest INACTIVE correlations, the union is
supp(x) ∪ those, pruning keeps the k largest LS entries, and a
residual non-decrease stops with the previous iterate kept.
"""

from __future__ import annotations

import numpy as np


def solve(A: np.ndarray, y: np.ndarray, k_sparsity: int,
          tolerance: float, max_iterations: int = 20):
    """Returns (x, rounds, resid_norm, support_sorted)."""
    A = np.asarray(A)
    y = np.asarray(y)
    m, n = A.shape
    k = int(k_sparsity)
    # the engine's pool clamp, mirrored exactly: the union never
    # exceeds the row count (solvers/cosamp.py review finding)
    k2 = min(2 * k, n - k, m - k)

    supp: list[int] = []
    vals = np.zeros(0, A.dtype)
    rss = float(y @ y)
    it = 0
    while it < max_iterations and rss > tolerance * tolerance:
        r = y - A[:, supp] @ vals if supp else y.copy()
        c = np.abs(A.T @ r)
        c[supp] = -np.inf
        top = np.argsort(-c, kind="stable")[:k2]
        omega = list(supp) + [int(j) for j in top]
        b, *_ = np.linalg.lstsq(A[:, omega], y, rcond=None)
        order = np.argsort(-np.abs(b), kind="stable")[:k]
        supp2 = [omega[int(p)] for p in order]
        vals2 = b[order]
        r2 = y - A[:, supp2] @ vals2
        rss2 = float(r2 @ r2)
        if not np.isfinite(rss2) or rss2 >= rss:
            break  # stall / degenerate round: previous iterate stands
        supp, vals, rss = supp2, vals2, rss2
        it += 1

    x = np.zeros(n, A.dtype)
    x[supp] = vals
    return x, it, float(np.sqrt(max(rss, 0.0))), sorted(supp)
