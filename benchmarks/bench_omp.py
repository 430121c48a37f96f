"""Batched OMP throughput — sustained, fenced (bench.py methodology).

OMP is the framework's greedy beyond-reference family (solvers/omp.py):
k column picks = k iterations, each one correlation product plus O(k²)
slot work over the online Gram inverse. This harness records the
vmapped jax engine at the headline-adjacent compressed-sensing shape
in the Gram-gather formulation (gram=True pins it) and whatever the
batch·k < 2m router picks for gram=False ("dense" — two amortized
passes — at both bench shapes; labels come from explain()), with
exact-support recovery as the correctness gate, plus a threaded
native-host row for the small-problem floor.

Run (GPU):  python benchmarks/bench_omp.py [--quick]
CPU plumbing check: add --cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from benchmarks._common import make_sparse_problem
from sparse_solvers_tpu.utils.config import use_compile_cache


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--large", action="store_true",
                    help="gram-free large-n regime (2048x65536, Gram = "
                         "16 GiB unmaterializable): driver gram-free "
                         "rows vs the vmapped fallback")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        use_compile_cache()
    import jax.numpy as jnp
    import sparse_solvers_tpu as ss

    if args.quick or args.cpu:
        m, n, k, batch = 256, 512, 8, 32
    elif args.large:
        # the homotopy gram-free config (benchmarks/bench_gram_free.py)
        # so rows are comparable: Gram would be n² = 16 GiB
        m, n, k, batch = 2048, 65536, 16, 256
    else:
        m, n, k, batch = 4096, 8192, 64, 256
    tol = 1e-2
    max_iter = k + 8  # budget: the true sparsity + stall headroom
    A, X0, Y = make_sparse_problem(m, n, k, batch, seed=0)
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind}, problem {m}x{n} k={k} b={batch}",
          file=sys.stderr)
    sup_true = [set(np.flatnonzero(X0[b]).tolist()) for b in range(batch)]

    Yd = jnp.asarray(Y)
    # row 1-2: the slot-space batch driver (the default route for
    # batched f32 GPU solves) at one-pass and HIGH precision;
    # rows 3-4: the vmapped formulations with the driver forbidden
    # (gram=True pins Gram-gather; gram=False routes "dense" at both
    # bench shapes). Labels report what ran, from explain().
    cases = [(dict(precision="default"), None),
             (dict(precision="high"), None),
             (dict(gram=True), "0"),
             (dict(gram=False), "0")]
    if args.large:
        # n² is unmaterializable: gram-free driver (one-pass + HIGH)
        # vs the vmapped dense-corr fallback
        cases = [(dict(gram=False, precision="default"), "1"),
                 (dict(gram=False, precision="high"), "1"),
                 (dict(gram=False), "0")]
    for kw, bn in cases:
        if bn is None:
            os.environ.pop("SS_BATCH_NATIVE", None)
        else:
            os.environ["SS_BATCH_NATIVE"] = bn
        solver = ss.Omp(A, engine="jax", **kw)
        plan = solver.explain(batch=batch, max_iterations=max_iter)
        driver = plan["corr"] == "driver"
        # row names: "batch_driver[_gramfree]" + a "precision" field; the
        # driver's error is the post-loop certificate
        if driver:
            name = ("batch_driver_gramfree" if plan.get("gram_free")
                    else "batch_driver")
        else:
            name = "corr_" + plan["corr"]
        run = lambda: solver.solve_batch_on_device(Yd, tol, max_iter)
        X, rep = run()
        np.asarray(rep.iter)  # fence warmup (compile + run)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            X, rep = run()
        np.asarray(rep.iter)  # one fence for the pipelined window
        sec = (time.perf_counter() - t0) / args.reps
        Xh = np.asarray(X)
        iters = np.asarray(rep.iter)
        exact = float(np.mean([
            set(np.argsort(-np.abs(Xh[b]))[:k].tolist()) == sup_true[b]
            for b in range(batch)]))
        err_key = "max_err_certified" if driver else "max_err"
        emit(bench="omp_batch", formulation=name,
             precision=plan["precision"], m=m, n=n, k=k,
             batch=batch, tol=tol, max_iterations=max_iter,
             ms_per_batch=round(sec * 1e3, 2),
             solves_per_sec=round(batch / sec, 1),
             nnz_per_sec=round(batch * k / sec, 1),
             mean_iters=float(iters.mean()),
             exact_support_rate=exact, device=dev.device_kind,
             **{err_key: float(np.asarray(rep.solution_error).max())})
    os.environ.pop("SS_BATCH_NATIVE", None)

    # generalized-OMP picks sweeps (round 5): the slot-space driver's
    # gOMP rounds (J insert-kernel calls per fused q pass — the greedy
    # family's record route, 8972 solves/s at J=4) and the pinned
    # Gram-gather vmapped formulation (the route for gram-pinned/f64)
    if not args.large:
        for J in ((2,) if args.quick else (2, 4, 8)):
            solver = ss.Omp(A, engine="jax", precision="default",
                            picks=J)
            run = lambda: solver.solve_batch_on_device(Yd, tol, 2 * k)
            X, rep = run()
            np.asarray(rep.iter)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                X, rep = run()
            np.asarray(rep.iter)
            sec = (time.perf_counter() - t0) / args.reps
            iters = np.asarray(rep.iter)
            emit(bench="omp_batch", formulation="gomp_batch_driver",
                 selection="iterated_argmax", picks=J, m=m, n=n, k=k,
                 batch=batch, tol=tol,
                 ms_per_batch=round(sec * 1e3, 2),
                 solves_per_sec=round(batch / sec, 1),
                 mean_cols=float(iters.mean()),
                 max_err_certified=float(
                     np.asarray(rep.solution_error).max()),
                 device=dev.device_kind)
        for J in ((2,) if args.quick else (1, 2, 4, 8)):
            solver = ss.Omp(A, engine="jax", precision="high", picks=J,
                            gram=True)
            run = lambda: solver.solve_batch_on_device(Yd, tol, 2 * k)
            X, rep = run()
            np.asarray(rep.iter)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                X, rep = run()
            np.asarray(rep.iter)
            sec = (time.perf_counter() - t0) / args.reps
            iters = np.asarray(rep.iter)
            emit(bench="omp_batch", formulation="gomp_vmapped_gram",
                 picks=J, m=m, n=n, k=k, batch=batch, tol=tol,
                 ms_per_batch=round(sec * 1e3, 2),
                 solves_per_sec=round(batch / sec, 1),
                 mean_cols=float(iters.mean()),
                 mean_rounds=float(np.ceil(iters / J).mean()),
                 max_err=float(np.asarray(rep.solution_error).max()),
                 device=dev.device_kind)

    # native host row (threaded batch) at a host-scaled shape
    from sparse_solvers_tpu.backend import native
    if native.available():
        hm, hn, hk, hb = (64, 128, 4, 64) if (args.quick or args.cpu) \
            else (256, 1024, 16, 64)
        Ah, Xh0, Yh = make_sparse_problem(hm, hn, hk, hb, seed=1)
        Xn, itn, errn = native.omp_solve_batch(Ah, Yh, tol, hk + 8, hk + 8)
        t0 = time.perf_counter()
        Xn, itn, errn = native.omp_solve_batch(Ah, Yh, tol, hk + 8, hk + 8)
        sec = time.perf_counter() - t0
        exact = float(np.mean([
            set(np.argsort(-np.abs(Xn[b]))[:hk].tolist())
            == set(np.flatnonzero(Xh0[b]).tolist()) for b in range(hb)]))
        emit(bench="omp_batch", formulation="native_host_threaded", m=hm,
             n=hn, k=hk, batch=hb, tol=tol,
             ms_per_batch=round(sec * 1e3, 2),
             solves_per_sec=round(hb / sec, 1),
             mean_iters=float(itn.mean()), exact_support_rate=exact,
             device="host", blas=native.blas_info()["active"])


if __name__ == "__main__":
    main()
