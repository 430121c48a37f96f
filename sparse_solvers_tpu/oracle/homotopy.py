"""NumPy oracle for the homotopy solver.

Plays the role of the reference's pure-NumPy oracle
(reference: bindings/python/reference/homotopy.py) for this library: a
simple, obviously-correct implementation used by the test suite to
cross-check the jitted solver. It follows the same algorithm as the C++
solver (reference: src/solvers/homotopy-cpu.cpp:186-275) — including the
sign-deadzone, leftmost tie-break and init-direction quirks — but recomputes
the active-set Gram inverse densely every iteration instead of maintaining
it incrementally, so a bug in the online-inverse update cannot hide here.
"""

from __future__ import annotations

import numpy as np


def sign_deadzone(v, tol):
    out = np.zeros_like(np.asarray(v, dtype=float))
    v = np.asarray(v, dtype=float)
    out[v > tol] = 1.0
    out[v < -tol] = -1.0
    return out


def solve(A, y, tolerance, max_iterations=100):
    """Returns (x, iterations, solution_error)."""
    A = np.asarray(A, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    m, n = A.shape

    x = np.zeros(n)
    mask = np.zeros(n, dtype=bool)

    c = A.T @ (y - A @ x)
    idx0 = int(np.argmax(np.abs(c)))
    c_inf = abs(c[idx0])
    mask[idx0] = True

    # initial direction: sign of the NORM (i.e. +1 above tol), as in the C++
    # (homotopy-cpu.cpp:223-227)
    inv = _gram_inv(A, mask)
    direction = np.zeros(n)
    direction[idx0] = sign_deadzone(c_inf, tolerance) * inv[0, 0]

    it = 0
    while True:
        it += 1

        gamma, idx = _find_max_gamma(A, c, x, direction, c_inf, mask)

        mask[idx] = ~mask[idx]
        if not mask.any():
            break

        inv = _gram_inv(A, mask)

        x = x + gamma * direction
        c = A.T @ (y - A @ x)

        cg = sign_deadzone(c[mask], tolerance)
        direction = np.zeros(n)
        direction[mask] = inv @ cg

        c_inf = np.max(np.abs(c))

        if not (it < max_iterations and c_inf > tolerance):
            break

    return x, it, c_inf


def _gram_inv(A, mask):
    Ag = A[:, mask]
    return np.linalg.inv(Ag.T @ Ag)


def _find_max_gamma(A, c, x, direction, c_inf, mask):
    n = A.shape[1]
    q = A.T @ (A @ direction)

    best = np.finfo(np.float64).max
    idx = 0
    for i in range(n):
        prev = best
        if mask[i]:
            with np.errstate(divide="ignore", invalid="ignore"):
                t = -x[i] / direction[i]
            if t > 0.0 and t < best:
                best = t
        else:
            dl, dr = 1.0 - q[i], 1.0 + q[i]
            if dl != 0.0:
                t = (c_inf - c[i]) / dl
                if t > 0.0 and t < best:
                    best = t
            if dr != 0.0:
                t = (c_inf + c[i]) / dr
                if t > 0.0 and t < best:
                    best = t
        if prev > best:
            idx = i
    return best, idx
