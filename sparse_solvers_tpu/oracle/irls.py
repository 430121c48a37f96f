"""NumPy oracle for the IRLS solver.

Role analog of reference bindings/python/reference/irls.py, written to match
the C++ solver's exact semantics (reference: src/solvers/irls-cpu.cpp:39-124)
so the jitted solver can be cross-checked against it: raw-value (not
absolute) second-largest selection, threshold-then-commit ordering, eps as
the reported solution error, and the do-while termination rule.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla


def solve(A, y, tolerance, max_iterations=100, stabilized=False):
    """Returns (x, iterations, eps, spd_failure).

    ``stabilized`` is the oracle counterpart of the solver's
    scale-stabilized variant (solvers/irls.py solve_irls_core): the
    Newton iterate is divided by its maximum before the threshold/eps/
    weight updates, removing the reference recurrence's intrinsic scale
    divergence. Support decisions per iteration are unchanged."""
    A = np.asarray(A, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    m, n = A.shape
    assert m >= n, "underdetermined systems not supported"

    Q, R = np.linalg.qr(A, mode="reduced")
    p = 0.9

    x = np.zeros(n)
    w = np.ones(n)
    eps = 1.0
    abstol = 1.0
    x2 = 1.0
    it = 0
    spd = False

    while True:
        ok, xn = _newton(Q, R, y, w)
        if not ok:
            spd = True
            break

        if stabilized:
            mx = np.max(xn)
            if mx > 0:
                xn = xn / mx
        abstol = np.max(xn) * tolerance
        xn = np.where(xn < abstol, 0.0, xn)
        x = xn.copy()

        x2 = np.partition(xn, -2)[-2]  # second-largest raw value
        eps = min(eps, x2 / n)

        # exactly-sparse x with eps == 0 yields inf weights; the loop exits
        # before using them (same as the C++, irls-cpu.cpp:113-118), so
        # silence the benign numpy warnings
        with np.errstate(divide="ignore", invalid="ignore"):
            w = np.power(x * x + eps, (p / 2.0) - 1.0)
            w = w / np.sum(w)
        it += 1

        if not (it < max_iterations and x2 > abstol):
            break

    s = np.sum(x)
    x = x / s
    return x, it, eps, spd


def _newton(Q, R, y, w):
    G = Q.T @ (Q * w)
    eps = np.finfo(G.dtype).eps
    try:
        L = np.linalg.cholesky(G)
    except np.linalg.LinAlgError:
        return False, None
    if not (np.all(np.isfinite(L)) and np.all(np.diag(L) > eps)):
        return False, None
    s = sla.cho_solve((L, True), Q.T @ y)
    t = Q @ s
    xn = Q.T @ t
    xn = sla.solve_triangular(R, xn, lower=False)
    return True, xn
