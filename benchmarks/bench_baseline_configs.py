"""Named benchmarks for the BASELINE.json config list, with support
recovery as a first-class metric.

Configs (BASELINE.json "configs"):
  1. README toy — 10×10 Gaussian+identity, 1-sparse, tol=0.1; correctness
     fields (error / sparsity / argmax) per reference README.md:30-33.
  2. Homotopy, 512×1024 Gaussian, k=32-sparse, support-recovery check.
  3. IRLS on the matching compressive problems. The reference's IRLS
     requires m ≥ n (qr assert; irls_test.cpp "underdetermined systems
     not supported"), so this config runs the overdetermined counterpart
     1024×512 with k=32 — the same ensemble in the regime IRLS supports.
     Its recovery metric is argmax-in-support: the reference's own IRLS
     property tests assert argmax identification only (test_util.h
     noisy_patterns/permutations), and on multi-sparse ensembles the
     p=0.9 reweighting spreads mass and trips spd_failure even in the
     f64 oracle — exact top-k support equality is not this algorithm's
     contract (the exact-k rate is still reported for reference).
  4. Batched recovery: 10k signals against one shared 1024×4096 A
     (face-recognition workload), chunked through solve_batch.

Support recovery rate = fraction of signals whose k largest |x| entries
are exactly the true support. One JSON line per config; timing fenced by
materializing report scalars (BASELINE.md methodology).

Run: python benchmarks/bench_baseline_configs.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_ensemble(m, n, k, batch, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((batch, n))
    sups = np.zeros((batch, k), np.int64)
    for b in range(batch):
        sup = np.sort(rng.choice(n, k, replace=False))
        X[b, sup] = rng.uniform(0.5, 1.0, k)
        sups[b] = sup
    Y = X @ A.T
    return A.astype(np.float32), Y.astype(np.float32), sups


def support_rate(X, sups):
    """Fraction of lanes whose top-k |x| equals the true support."""
    k = sups.shape[1]
    got = np.argsort(-np.abs(X), axis=1)[:, :k]
    return float(np.mean([set(got[i]) == set(sups[i])
                          for i in range(X.shape[0])]))


def emit(**kw):
    print(json.dumps(kw), flush=True)



def _setup_cache():
    from sparse_solvers_tpu.utils.config import use_compile_cache
    use_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    _setup_cache()

    import sparse_solvers_tpu as ss

    # --- config 1: README toy (reference README.md:14-33) -------------
    rng = np.random.RandomState(42)
    N1 = 10
    A1 = (rng.randn(N1, N1) + np.identity(N1)).astype(np.float32)
    A1 = ss.norm_l1(A1)
    x_true = np.zeros(N1, np.float32)
    x_true[2] = 1.0
    y1 = A1 @ x_true
    x, rep = ss.Homotopy(A1).solve(y1, tolerance=0.1)
    emit(bench="baseline_config", config=1, name="readme_toy_10x10",
         solution_error=round(rep.solution_error, 6),
         sparsity=round(float(np.mean(x == 0)), 3),
         argmax=int(np.argmax(x)), argmax_ok=bool(np.argmax(x) == 2))

    # --- config 2: homotopy 512×1024 k=32 support recovery -------------
    m, n, k = (128, 256, 8) if args.quick else (512, 1024, 32)
    batch = 32 if args.quick else 256
    A, Y, sups = make_ensemble(m, n, k, batch, seed=1)
    solver = ss.Homotopy(A, k_max=(3 * k) // 2)
    X, reps = solver.solve_batch(Y, tolerance=1e-2, max_iterations=2 * k)
    np.asarray(reps.iter)
    t0 = time.time()
    X, reps = solver.solve_batch(Y, tolerance=1e-2, max_iterations=2 * k)
    iters = np.asarray(reps.iter)
    dt = time.time() - t0
    emit(bench="baseline_config", config=2,
         name=f"homotopy_{m}x{n}_k{k}",
         solves_per_sec=round(batch / dt, 2),
         support_recovery_rate=support_rate(np.asarray(X), sups),
         mean_iterations=float(np.mean(iters)))

    # --- config 3: IRLS on the overdetermined counterpart --------------
    mi, ni = (256, 128) if args.quick else (1024, 512)
    Ai, Yi, supi = make_ensemble(mi, ni, k, batch, seed=2)
    isolver = ss.Irls(Ai)
    Xi, ri = isolver.solve_batch(Yi, tolerance=1e-4, max_iterations=50)
    np.asarray(ri.iter)
    t0 = time.time()
    Xi, ri = isolver.solve_batch(Yi, tolerance=1e-4, max_iterations=50)
    np.asarray(ri.iter)
    dt = time.time() - t0
    Xi = np.asarray(Xi)
    argmax_rate = float(np.mean([
        int(np.argmax(np.abs(Xi[i]))) in set(supi[i])
        for i in range(batch)]))
    emit(bench="baseline_config", config=3,
         name=f"irls_{mi}x{ni}_k{k}",
         solves_per_sec=round(batch / dt, 2),
         argmax_recovery_rate=argmax_rate,
         exact_support_rate=support_rate(Xi, supi),
         mean_iterations=float(np.mean(np.asarray(ri.iter))),
         spd_failures=int(np.sum(np.asarray(ri.spd_failure))))

    # --- config 3 at its literal shape: IrlsCg on 512×1024 -------------
    # BASELINE.json configs[2] reads "IRLS … on the same 512×1024
    # problems" — underdetermined, which the reference IRLS rejects
    # outright (qr assert; irls_test.cpp:53 "underdetermined systems not
    # supported"); the row above records the reference-faithful
    # overdetermined counterpart. This row covers the config as written
    # with the framework's factorization-free CG-IRLS (api.IrlsCg,
    # beyond-reference), so the table carries a passing solver at the
    # literal shape next to the reference-faithful one.
    Ac, Yc, supc = make_ensemble(m, n, k, batch, seed=2)  # 512×1024 k=32
    csolver = ss.IrlsCg(Ac, k_sparsity=2 * k, cg_max_iterations=96)
    tol_cg, it_cg = 1e-3, 30
    Xc, rc = csolver.solve_batch(Yc, tolerance=tol_cg, max_iterations=it_cg)
    np.asarray(rc.iter)
    t0 = time.time()
    Xc, rc = csolver.solve_batch(Yc, tolerance=tol_cg, max_iterations=it_cg)
    np.asarray(rc.iter)
    dt = time.time() - t0
    Xc = np.asarray(Xc)
    emit(bench="baseline_config", config=3,
         name=f"irls_cg_{m}x{n}_k{k}_literal_shape",
         solves_per_sec=round(batch / dt, 2),
         exact_support_rate=support_rate(Xc, supc),
         mean_iterations=float(np.mean(np.asarray(rc.iter))),
         spd_failures=int(np.sum(np.asarray(rc.spd_failure))))

    # --- config 4: 10k signals vs shared 1024×4096 A --------------------
    m4, n4, k4 = (256, 1024, 8) if args.quick else (1024, 4096, 32)
    total = 512 if args.quick else 10_000
    chunk = 256 if args.quick else 2_000
    A4, Y4, sup4 = make_ensemble(m4, n4, k4, total, seed=3)
    solver4 = ss.Homotopy(A4, k_max=(3 * k4) // 2)
    X0, r0 = solver4.solve_batch(Y4[:chunk], tolerance=1e-2,
                                 max_iterations=2 * k4)
    np.asarray(r0.iter)  # compile
    t0 = time.time()
    outs = []
    reps4 = []
    for lo in range(0, total, chunk):
        Xc, rc = solver4.solve_batch(Y4[lo:lo + chunk], tolerance=1e-2,
                                     max_iterations=2 * k4)
        outs.append(Xc)
        reps4.append(rc)
    iters4 = np.concatenate([np.asarray(r.iter) for r in reps4])
    dt = time.time() - t0
    X4 = np.concatenate([np.asarray(o) for o in outs])
    emit(bench="baseline_config", config=4,
         name=f"batched_{total}x_{m4}x{n4}_k{k4}",
         solves_per_sec=round(total / dt, 2),
         support_recovery_rate=support_rate(X4, sup4),
         mean_iterations=float(np.mean(iters4)))


if __name__ == "__main__":
    sys.exit(main())
