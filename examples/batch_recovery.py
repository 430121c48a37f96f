"""Batched sparse-recovery example — the face-recognition-style workload.

One sensing matrix (the "dictionary": columns are known patterns /
training faces), many observed signals to classify by sparse coding —
the motivating workload of the reference library (needle-in-haystack
pattern search) scaled to device batch throughput.

Run: python examples/batch_recovery.py [m] [n] [k] [batch]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__ if "__file__" in globals() else "."))))

if os.environ.get("SS_EXAMPLE_CPU"):
    import jax
    jax.config.update("jax_platforms", "cpu")

import sparse_solvers_tpu as ss


def main():
    argv = [int(a) for a in sys.argv[1:]]
    m, n, k, batch = (argv + [512, 1024, 8, 64][len(argv):])[:4]

    rng = np.random.RandomState(0)
    # dictionary with unit-L2 columns (standard compressive-sensing form)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)

    # each signal is a sparse nonnegative combination of k dictionary atoms
    X_true = np.zeros((batch, n), np.float32)
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        X_true[b, sup] = rng.uniform(0.5, 1.0, k)
    Y = X_true @ A.T

    solver = ss.Homotopy(A)             # construct once; Gram precomputed
    t0 = time.time()
    X, reports = solver.solve_batch(Y, tolerance=1e-2, max_iterations=4 * k)
    X = np.asarray(X)
    dt = time.time() - t0

    iters = np.asarray(reports.iter)
    support_hit = np.mean([
        set(np.flatnonzero(X[b] > 0.1)) == set(np.flatnonzero(X_true[b]))
        for b in range(batch)])
    print(f"{batch} solves of {m}x{n} (k={k}) in {dt*1e3:.1f} ms "
          f"({batch/dt:.1f} solves/s, first call includes compile)")
    print(f"mean path length {iters.mean():.1f}; "
          f"exact support recovery on {100*support_hit:.0f}% of signals")

    # single-signal latency path (auto-routes small problems to the
    # native C++ backend)
    x1, rep = solver.solve(Y[0], tolerance=1e-2, max_iterations=4 * k)
    print(f"single solve: iter={rep.iter} "
          f"solution_error={rep.solution_error:.2e}")


if __name__ == "__main__":
    main()
