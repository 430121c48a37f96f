"""Serving-loop example — jit-composable, certified, pipelined.

How a production recovery service drives the solver at full device
throughput: construct once, then feed batches through the
jit-composable `solve_batch_on_device` entry (device arrays in and out,
no host sync per call) with `precision="certified"` — the path runs at
one-pass speed and every lane carries a parity-grade
convergence certificate; the loop inspects the certificates *after*
fencing and re-solves any failing batch at parity precision.

`explain()` shows the execution plan (engine, formulation, capacity
tiers, bf16 q product) before anything compiles.

Run: python examples/serving_loop.py      (SS_EXAMPLE_CPU=1 for CPU)
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

import jax
import sparse_solvers_tpu as ss


def main():
    m, n, k, batch, n_batches = 512, 1024, 16, 64, 8
    tol, max_iter = 1e-2, 64

    rng = np.random.RandomState(0)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)

    solver = ss.Homotopy(A, precision="certified")
    print("plan:", solver.explain(batch=batch, max_iterations=max_iter))

    def make_batch(seed):
        r = np.random.RandomState(seed)
        X = np.zeros((batch, n), np.float32)
        for b in range(batch):
            X[b, r.choice(n, k, replace=False)] = r.uniform(0.5, 1.0, k)
        return jax.device_put((X @ A.T).astype(np.float32))

    batches = [make_batch(s) for s in range(n_batches)]

    # warmup (compile)
    X, rep = solver.solve_batch_on_device(batches[0], tol, max_iter)
    np.asarray(rep.iter)

    # pipelined serving: dispatch everything, fence once
    t0 = time.time()
    out = [solver.solve_batch_on_device(Y, tol, max_iter) for Y in batches]
    for _, rep in out:
        np.asarray(rep.iter)
    dt = time.time() - t0

    # certificate audit (off the timed path; a failing batch would be
    # re-solved at precision="high" — or route it through solve_batch,
    # which does this automatically)
    failed = sum(int(np.sum(~(np.asarray(rep.solution_error) <= tol)))
                 for _, rep in out)
    total = batch * n_batches
    print(f"{total} certified solves in {dt*1e3:.1f} ms "
          f"({total/dt:.0f} solves/s pipelined); "
          f"{failed}/{total} lanes failed certification")

    # gallery churn: swap one dictionary column in place — the cached
    # Gram updates incrementally and every compiled executable stays
    # valid, so the serving loop keeps running without a re-warmup
    new_col = np.random.RandomState(99).randn(m).astype(np.float32)
    new_col /= np.linalg.norm(new_col)
    solver.update_column(7, new_col)
    # probe with the SAME batch shape the loop serves: the compiled
    # program (keyed on shape and plan) is genuinely reused — a
    # different batch size would be a fresh jit specialization
    probe = jax.device_put(np.tile(new_col, (batch, 1)))
    Xc, repc = solver.solve_batch_on_device(probe, tol, max_iter)
    hit = int(np.argmax(np.asarray(Xc)[0]))
    print(f"after update_column(7): probe for the new gallery entry "
          f"recovers column {hit} (expected 7), same compiled program")


if __name__ == "__main__":
    main()
