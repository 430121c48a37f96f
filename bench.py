"""Headline benchmark — batched homotopy sparse recovery on the GPU.

Workload (BASELINE.json): 4096×8192 float32 sensing matrix, k=64-sparse
signals, batched recovery. Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

value        = solves/sec on the default device
vs_baseline  = value / CPU-baseline solves/sec, where the CPU baseline is a
               faithful NumPy/BLAS implementation of the reference C++
               algorithm (sparse_solvers_tpu/oracle/cpu_baseline.py; the
               reference publishes no numbers and its C++ tree can't be
               built here — see BASELINE.md).

Extra diagnostics (the device with its nvidia-smi name and power limit,
iterations, per-batch latency) go to stderr.
Env knobs: SS_BENCH_M / SS_BENCH_N / SS_BENCH_K / SS_BENCH_BATCH /
SS_BENCH_CPU_SOLVES / SS_BENCH_SMALL=1 (tiny smoke configuration).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def make_problem(m, n, k, batch, seed=0, dtype=np.float32):
    """Gaussian sensing matrix with unit-L2 columns (the standard
    compressive-sensing ensemble), k-sparse positive signals. Unit-norm
    columns keep max|Aᵀy| ~ O(1) so a 1e-2 tolerance demands a genuine
    ~k-segment homotopy path."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(np.float64)
    A = A / np.linalg.norm(A, axis=0)
    X = np.zeros((batch, n))
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        X[b, sup] = rng.uniform(0.5, 1.0, k)
    Y = X @ A.T
    return A.astype(dtype), Y.astype(dtype)


def main():
    small = os.environ.get("SS_BENCH_SMALL") == "1"
    M = int(os.environ.get("SS_BENCH_M", 256 if small else 4096))
    N = int(os.environ.get("SS_BENCH_N", 512 if small else 8192))
    K = int(os.environ.get("SS_BENCH_K", 8 if small else 64))
    BATCH = int(os.environ.get("SS_BENCH_BATCH", 8 if small else 256))
    CPU_SOLVES = int(os.environ.get("SS_BENCH_CPU_SOLVES", 1 if small else 5))
    TOL = 1e-2
    MAX_ITER = 2 * K  # headroom over the k ideal path segments
    # Active-set capacity: 1.5x the signal sparsity. Every K-proportional
    # cost (padded-inverse updates, the insert's Gram-column gather)
    # scales with it; a lane that exceeded capacity would break with a
    # clean flag (homotopy_batch overflow semantics) and fail the
    # recovery check below — none does on this workload (paths are
    # insert-only, max support = k).
    KMAX = int(os.environ.get("SS_BENCH_KMAX", (3 * K) // 2))
    # Matmul precision for the solve loop. The headline runs "certified"
    # (default): the path at one-pass (bf16 q product) speed, each lane's
    # final ‖Aᵀ(y−Ax)‖∞ — the solver's own convergence criterion —
    # recomputed at parity-grade precision (blas.PARITY) inside the same
    # compiled program; lanes whose certificate missed the tolerance are
    # re-solved at blas.PARITY (counted and timed below).
    # SS_BENCH_PRECISION=high|highest|default selects a fixed precision.
    PRECISION = os.environ.get("SS_BENCH_PRECISION", "certified")

    import jax
    import sparse_solvers_tpu as ss
    from sparse_solvers_tpu.ops import blas
    from sparse_solvers_tpu.oracle import cpu_baseline
    from sparse_solvers_tpu.utils.config import use_compile_cache
    from sparse_solvers_tpu.utils.profiling import card_label

    # persistent compilation cache: repeat runs skip the compile
    use_compile_cache()
    dev = jax.devices()[0]
    _log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())} "
         f"({card_label()}); problem {M}x{N} k={K} batch={BATCH} "
         f"max_iter={MAX_ITER}")

    A, Y = make_problem(M, N, K, BATCH)

    solver = ss.Homotopy(A, k_max=KMAX, precision=PRECISION)
    # pre-place the signal batch on device: the timed region measures the
    # solver, not the host->device stream of Y (which a serving system
    # pays once / overlaps)
    Y = jax.device_put(Y)
    t0 = time.time()
    # warmup through the same on-device entry the timed loops use, so
    # exactly one program compiles (solve_batch's host path traces a
    # second, differently-keyed executable for no benchmarking benefit)
    Xw, repw = jax.block_until_ready(
        solver.solve_batch_on_device(Y, TOL, MAX_ITER))
    _log(f"warmup (compile + run): {time.time() - t0:.2f}s; "
         f"iters mean={np.mean(np.asarray(repw.iter)):.1f} "
         f"max={np.max(np.asarray(repw.iter))}")
    if PRECISION == "certified":
        # pre-warm the parity re-solve executable so a certification
        # failure inside the timed region pays solver work, not a
        # first-time compile
        jax.block_until_ready(solver._fn(
            MAX_ITER, batch=BATCH, precision=blas.PARITY)(
                solver._A, solver._G, Y, TOL))

    # Timed runs. Two numbers:
    #  * per-call latency — each run fenced with block_until_ready;
    #  * sustained throughput (the headline) — `runs` solves dispatched
    #    back-to-back, fenced once at the end, so dispatch overlaps the
    #    device as in any pipelined serving loop. Total wall time over
    #    all solved batches; nothing is discarded.
    # The timed loops use the jit-composable on-device entry (device
    # arrays in/out, no host sync per call) — how a pipelined serving
    # loop drives the solver. Under "certified" its reports carry the
    # fused parity-grade certificate per lane; failures are counted
    # after the fence and any failing batch is re-solved at blas.PARITY
    # inside the timed total, so the headline pays for its guarantee.
    runs = 5
    times = []
    for _ in range(runs):
        t0 = time.time()
        X, rep = jax.block_until_ready(
            solver.solve_batch_on_device(Y, TOL, MAX_ITER))
        times.append(time.time() - t0)
    dt_call = sorted(times)[len(times) // 2]

    t0 = time.time()
    reps = []
    for _ in range(runs):
        X, rep = solver.solve_batch_on_device(Y, TOL, MAX_ITER)
        reps.append(rep)
    jax.block_until_ready(reps)  # fence the whole pipeline
    dt_total = time.time() - t0
    if PRECISION == "certified":
        # the per-lane certificates were computed on device inside the
        # timed region; reading the flags back is result consumption
        # (untimed, like reading X). Any re-solve a flag triggers is
        # solver work and is added to the timed total (the parity
        # executable was pre-warmed above so this measures solving, not
        # compiling). NaN-safe predicate: a non-finite certificate
        # counts as failing.
        fails = [int(np.sum(~(np.asarray(r.solution_error) <= TOL)))
                 for r in reps]
        t1 = time.time()
        for i, nf in enumerate(fails):
            if nf:  # pay the certified re-solve for this batch
                Xh, rh = jax.block_until_ready(solver._fn(
                    MAX_ITER, batch=BATCH, precision=blas.PARITY)(
                        solver._A, solver._G, Y, TOL))
                if i == len(fails) - 1:
                    # the sanity checks below must describe the
                    # certified pipeline's actual output: merge the
                    # re-solved lanes into the last batch's results
                    sel = ~(np.asarray(rep.solution_error) <= TOL)
                    X = np.where(sel[:, None], np.asarray(Xh),
                                 np.asarray(X))
                    rep = type(rep)(
                        iter=np.where(sel, np.asarray(rh.iter),
                                      np.asarray(rep.iter)),
                        solution_error=np.where(
                            sel, np.asarray(rh.solution_error),
                            np.asarray(rep.solution_error)))
        dt_total += time.time() - t1
        _log(f"certified: {sum(fails)} lane(s) failed certification "
             f"across {runs} batches")
    dt = dt_total / runs
    solves_per_sec = BATCH / dt
    _log(f"per-call latency: {dt_call*1e3:.1f} ms/batch "
         f"({BATCH/dt_call:.0f} solves/s incl. dispatch)")

    iters = float(np.max(np.asarray(rep.iter)))
    # per-primitive device times live in benchmarks/bench_kernels.py;
    # here report the per-iteration rate the phases sum to
    _log(f"{dev.device_kind}: {dt*1e3:.1f} ms/batch -> "
         f"{solves_per_sec:.2f} solves/s; "
         f"{dt/iters*1e6:.0f} us/iteration at {iters:.0f} path iterations")

    # recovery sanity: solutions reconstruct their signals
    recon = np.asarray(X) @ A.T
    err = np.max(np.abs(recon - Y))
    _log(f"recovery max |Ax - y| = {err:.2e}")

    # CPU baseline (reference algorithm, NumPy BLAS) — median of the
    # per-solve times: the host is shared, and a mean lets one
    # contended solve swing the vs_baseline denominator by 2x
    Yh = np.asarray(Y)  # one untimed device->host transfer (Y[b] on the
    # device array would put a transfer in each timed solve)
    cpu_times = []
    for b in range(CPU_SOLVES):
        t0 = time.time()
        cpu_baseline.solve(A, Yh[b], TOL, MAX_ITER)
        cpu_times.append(time.time() - t0)
    cpu_dt = sorted(cpu_times)[len(cpu_times) // 2]
    cpu_solves_per_sec = 1.0 / cpu_dt
    _log(f"cpu baseline: {cpu_dt:.2f} s/solve -> "
         f"{cpu_solves_per_sec:.3f} solves/s")

    print(json.dumps({
        "metric": f"homotopy_solves_per_sec_{M}x{N}_k{K}_b{BATCH}",
        "value": round(solves_per_sec, 3),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / cpu_solves_per_sec, 2),
    }))


if __name__ == "__main__":
    main()
