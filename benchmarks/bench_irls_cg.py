"""CG-IRLS benchmark — underdetermined basis pursuit at scales the
reference cannot express.

The reference IRLS rejects m < n outright (irls_test.cpp:53) and its
m ≥ n path needs a one-time O(mn²) QR; CG-IRLS (solvers/irls_cg.py) is
factorization-free, so this harness records (a) recovery throughput on a
moderate compressed-sensing ensemble and (b) a large-n config whose Gram
(n² = 16 GiB at n=65536) could never be materialized — the regime the
solver exists for. Per row: ms/batch, solves/s, mean outer iterations,
support-recovery rate against the planted ground truth, and the sensing
matrix's byte size (each CG step streams A twice — one matvec + one
rmatvec — but per-lane CG step counts are internal to the while_loop, so
no bandwidth figure is derived here).

Timing: persistent compile cache, fenced timed regions (materialize a
small output), first timed run discarded, sustained rate over
back-to-back batches.

Run (GPU):        python benchmarks/bench_irls_cg.py
CPU smoke:        python benchmarks/bench_irls_cg.py --cpu --quick
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from sparse_solvers_tpu.utils.config import use_compile_cache


def emit(**kw):
    print(json.dumps(kw), flush=True)


def run_config(ss, m, n, k, batch, tol, max_iter, cg_max, repeats=3):
    import jax
    from benchmarks._common import make_sparse_problem

    A, Xtrue, Y = make_sparse_problem(m, n, k, batch, signed=True,
                                      amp=(0.5, 1.5))
    solver = ss.IrlsCg(A, k_sparsity=2 * k, cg_max_iterations=cg_max)
    t0 = time.perf_counter()
    X, rep = solver.solve_batch(Y, tolerance=tol, max_iterations=max_iter)
    np.asarray(rep.iter)  # fence
    compile_s = time.perf_counter() - t0

    # sustained: back-to-back batches, fenced once at the end
    t0 = time.perf_counter()
    for _ in range(repeats):
        X, rep = solver.solve_batch(Y, tolerance=tol,
                                    max_iterations=max_iter)
    iters = np.asarray(rep.iter)  # fence
    dt = (time.perf_counter() - t0) / repeats

    Xh = np.asarray(X)
    # support recovery: the k largest |x| per lane vs the planted support
    hits = 0
    for b in range(batch):
        top = np.argsort(-np.abs(Xh[b]))[:k]
        hits += set(top) == set(np.nonzero(Xtrue[b])[0])
    max_err = float(np.abs(Xh - Xtrue).max())
    mean_iters = float(iters.mean())
    solves_s = batch / dt
    emit(metric="irls_cg", m=m, n=n, k=k, batch=batch, tol=tol,
         max_outer=max_iter, cg_max=cg_max,
         ms_per_batch=round(dt * 1e3, 3), solves_per_sec=round(solves_s, 2),
         mean_outer_iterations=round(mean_iters, 2),
         support_recovery_rate=round(hits / batch, 4),
         max_abs_err=max_err, compile_s=round(compile_s, 1),
         backend=jax.default_backend(),
         a_bytes=int(A.nbytes))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    use_compile_cache()
    import sparse_solvers_tpu as ss

    if args.quick:
        run_config(ss, 64, 512, 5, 8, 1e-3, 30, 64, repeats=2)
        return
    # moderate CS ensemble (4x undersampled)
    run_config(ss, 512, 4096, 16, 64, 1e-3, 30, 96)
    # large-n regime: Gram would be n^2 = 16 GiB, QR inapplicable (m<n);
    # A itself is 256 MB — factorization-free is the only formulation
    run_config(ss, 1024, 65536, 24, 32, 1e-3, 25, 96)


if __name__ == "__main__":
    main()
