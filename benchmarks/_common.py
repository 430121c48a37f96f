"""Shared benchmark plumbing: the compressed-sensing ensemble. Harnesses
keep their own workload generators where the ensembles intentionally
differ (seeds / shape grids are part of each recorded row's identity);
the persistent compile cache is sparse_solvers_tpu.utils.config.
use_compile_cache.
"""

from __future__ import annotations

import numpy as np


def make_sparse_problem(m, n, k, batch, seed=0, signed=False,
                        amp=(0.5, 1.0)):
    """Shared compressed-sensing ensemble: unit-norm-column Gaussian A
    with a planted k-sparse ground truth per lane. Returns (A, X_true, Y).
    RNG call order is part of each recorded row's identity — ``signed``
    draws the sign vector before the amplitudes, matching the originally
    recorded harnesses."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((batch, n), np.float32)
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        if signed:
            a = rng.choice([-1.0, 1.0], k) * rng.uniform(amp[0], amp[1], k)
        else:
            a = rng.uniform(amp[0], amp[1], k)
        X[b, sup] = a
    return A, X, (X @ A.T).astype(np.float32)

