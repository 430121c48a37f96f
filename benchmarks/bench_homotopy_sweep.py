"""Homotopy shape sweep — the reference's benchmark grid on a workload
that actually exercises the path loop.

Reference harness: src/solvers/homotopy_bench.cpp:14-60 — shapes
M ∈ {16, 64, 256, 512} × N ∈ {16, 64, 256, 1024, 2048}, float32, with a
"Mean iterations" counter. Its noisy-pattern needle converges in ONE path
segment, so timing it measures dispatch overhead, not the solver (the
round-1 sweep recorded mean_iterations=1 on every row). This sweep keeps
the reference's shape grid and counter but runs the standard compressive-
sensing ensemble (unit-L2-norm Gaussian columns, k-sparse positive
signals, k = min(m,n)/8, tol=1e-2 — bench.py's workload), which drives
mean_iterations ≈ k.

Engines per shape:
  * native     — the C++ host backend, single solve (the reference regime)
  * jax        — jitted single solve on the default device
  * jax-batch  — 64 distinct-signal lanes, per-solve amortized (device regime)

One JSON line per (engine, shape):
  {"bench": "homotopy_sweep", "engine": ..., "m": ..., "n": ..., "k": ...,
   "ms_per_solve": ..., "mean_iterations": ...}

Timing: every measured region is fenced by materializing the report's
iteration counts; the first (compile) run is discarded.

Run: python benchmarks/bench_homotopy_sweep.py [--quick]
"""

from __future__ import annotations

import argparse
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time

import numpy as np


def make_problem(m, n, k, batch, seed=0):
    """k-sparse compressive-sensing ensemble (bench.py make_problem)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(np.float64)
    A = A / np.linalg.norm(A, axis=0)
    X = np.zeros((batch, n))
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        X[b, sup] = rng.uniform(0.5, 1.0, k)
    Y = X @ A.T
    return A.astype(np.float32), Y.astype(np.float32)



def _setup_cache():
    from sparse_solvers_tpu.utils.config import use_compile_cache
    use_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small subset of shapes")
    ap.add_argument("--engines", default="native,jax,jax-batch")
    args = ap.parse_args()
    _setup_cache()

    import sparse_solvers_tpu as ss
    from sparse_solvers_tpu.backend import native

    Ms = [16, 256] if args.quick else [16, 64, 256, 512]
    Ns = [64, 256] if args.quick else [16, 64, 256, 1024, 2048]
    engines = args.engines.split(",")
    TOL, BATCH = 1e-2, 64

    for m in Ms:
        for n in Ns:
            k = max(1, min(m, n) // 8)
            max_iter = max(16, 2 * k)
            A, Y = make_problem(m, n, k, BATCH, seed=m * 7 + n)
            y = Y[0]
            if "native" in engines and native.available():
                reps = max(3, int(2e6 / (m * n)))
                _, it, _ = native.homotopy_solve(A, y, TOL, max_iter, n)
                t0 = time.time()
                for _ in range(reps):
                    native.homotopy_solve(A, y, TOL, max_iter, n)
                dt = (time.time() - t0) / reps
                print(json.dumps({
                    "bench": "homotopy_sweep", "engine": "native",
                    "m": m, "n": n, "k": k,
                    "ms_per_solve": round(dt * 1e3, 4),
                    "mean_iterations": it}), flush=True)
            if "jax" in engines:
                solver = ss.Homotopy(A, engine="jax")
                x, rep = solver.solve(y, TOL, max_iter)  # compile
                reps = 10
                t0 = time.time()
                for _ in range(reps):
                    x, rep = solver.solve(y, TOL, max_iter)
                dt = (time.time() - t0) / reps
                print(json.dumps({
                    "bench": "homotopy_sweep", "engine": "jax",
                    "m": m, "n": n, "k": k,
                    "ms_per_solve": round(dt * 1e3, 4),
                    "mean_iterations": rep.iter}), flush=True)
            if "jax-batch" in engines:
                solver = ss.Homotopy(A, engine="jax")
                X, reps_ = solver.solve_batch(Y, TOL, max_iter)
                np.asarray(reps_.iter)  # fence (compile run, discarded)
                t0 = time.time()
                X, reps_ = solver.solve_batch(Y, TOL, max_iter)
                iters = np.asarray(reps_.iter)
                dt = (time.time() - t0) / BATCH
                print(json.dumps({
                    "bench": "homotopy_sweep", "engine": "jax-batch",
                    "m": m, "n": n, "k": k,
                    "ms_per_solve": round(dt * 1e3, 4),
                    "mean_iterations": float(np.mean(iters))}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
