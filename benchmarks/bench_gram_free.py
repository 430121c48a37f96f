"""Gram-free batch-driver benchmark — the large-n regime (config-5 proxy).

At n = 65536 the Gram matrix is n² × 4 B = 16 GiB: too large to keep
beside the rest of the state, so the dense-Gram throughput driver is not
used there. The gram-free driver (solvers/homotopy_batch.py, ``G=None``)
computes the insert's K live Gram entries on the fly, keeping the
slot-space formulation where the only other option at this scale is the
vmapped while-loop core. This harness
records both on identical ensembles:

  * driver (gram-free batch-native, precision="default" path), and
  * the vmapped core with the sparse-gather matvec (the pre-round-3
    routing for gram-disabled problems),

as sustained throughput over back-to-back batches, fenced once (first
run discarded).

Run (GPU):  python benchmarks/bench_gram_free.py [--quick]
CPU (plumbing check only): add --cpu.
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


def _sustained(fn, fence, reps):
    fn()  # warmup (compile + first run)
    fence()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    fence()
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--driver-only", action="store_true",
                    help="skip the vmapped-core comparison leg")
    ap.add_argument("--transfer", action="store_true",
                    help="also measure the dense-vs-compact host-return "
                         "end-to-end delta (solve_batch dense=False)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        use_compile_cache()
    import jax.numpy as jnp
    import sparse_solvers_tpu as ss

    if args.quick or args.cpu:
        m, n, k, batch, max_iter = 256, 2048, 8, 32, 24
    else:
        # Gram would be 16 GiB — the regime the driver exists for
        m, n, k, batch, max_iter = 2048, 65536, 16, 256, 40
    m = args.m or m
    n = args.n or n
    k = args.k or k
    batch = args.batch or batch
    max_iter = max(max_iter, 2 * k + 8)
    tol = 1e-2
    gib = n * n * 4 / (1 << 30)
    A, X0, Y = make_sparse_problem(m, n, k, batch, seed=0)
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind}, problem {m}x{n} k={k} b={batch} "
          f"(Gram would be {gib:.1f} GiB)", file=sys.stderr)

    solver = ss.Homotopy(A, gram=False, engine="jax", precision="default")
    Yd = jnp.asarray(Y)

    def run_driver():
        os.environ["SS_BATCH_NATIVE"] = "1"
        try:
            return solver.solve_batch_on_device(Yd, tol, max_iter)
        finally:
            del os.environ["SS_BATCH_NATIVE"]

    def run_core():
        os.environ["SS_BATCH_NATIVE"] = "0"
        try:
            return solver.solve_batch_on_device(Yd, tol, max_iter)
        finally:
            del os.environ["SS_BATCH_NATIVE"]

    cases = [("gram_free_driver", run_driver)]
    if not args.driver_only:
        cases.append(("vmapped_core_fallback", run_core))
    for name, run in cases:
        holder = {}

        def call(run=run, holder=holder):
            holder["out"] = run()

        def fence(holder=holder):
            X, rep = holder["out"]
            np.asarray(rep.iter)  # device->host read fences the stream

        sec = _sustained(call, fence, args.reps)
        X, rep = holder["out"]
        Xh = np.asarray(X)
        iters = np.asarray(rep.iter)
        err = float(np.max(np.abs(Xh @ A.T - Y)))
        sup_ok = float(np.mean([
            set(np.where(np.abs(Xh[i]) > 0.05)[0])
            == set(np.where(X0[i] != 0)[0]) for i in range(batch)]))
        emit(bench="gram_free", formulation=name, m=m, n=n, k=k,
             batch=batch, tol=tol, max_iterations=max_iter,
             ms_per_batch=round(sec * 1e3, 2),
             solves_per_sec=round(batch / sec, 1),
             nnz_per_sec=round(batch / sec * k, 1),
             mean_iters=float(iters.mean()),
             recovery_max_err=err, exact_support_rate=sup_ok,
             device=dev.device_kind, gram_gib=round(gib, 1))

    if args.transfer:
        # end-to-end host-return delta: the dense (b, n) scatter + f32
        # transfer vs the compact slot-space (values, indices) return
        # (solve_batch(dense=False)) — the north-star CSR ask measured
        # at the scale it matters (n = 131072 → 64 MiB dense vs ~2·b·k_max
        # elements compact). Timed per call INCLUDING np.asarray host
        # materialization; parity asserted via densify_batch.
        os.environ["SS_BATCH_NATIVE"] = "1"
        try:
            def run_dense():
                X, rep = solver.solve_batch(Y, tol, max_iter)
                return np.asarray(X), rep

            def run_compact():
                v, i, rep = solver.solve_batch(Y, tol, max_iter,
                                               dense=False)
                return np.asarray(v), np.asarray(i), rep

            Xd, _ = run_dense()
            vc, ic, _ = run_compact()   # warm both executables
            t0 = time.perf_counter()
            for _ in range(args.reps):
                Xd, _ = run_dense()
            sec_d = (time.perf_counter() - t0) / args.reps
            t0 = time.perf_counter()
            for _ in range(args.reps):
                vc, ic, _ = run_compact()
            sec_c = (time.perf_counter() - t0) / args.reps
        finally:
            del os.environ["SS_BATCH_NATIVE"]
        Xrt = np.asarray(ss.densify_batch(vc, ic, n))
        assert np.array_equal(Xrt, Xd), "compact/dense parity violated"
        emit(bench="gram_free_transfer", m=m, n=n, k=k, batch=batch,
             tol=tol, max_iterations=max_iter,
             ms_end_to_end_dense=round(sec_d * 1e3, 2),
             ms_end_to_end_compact=round(sec_c * 1e3, 2),
             dense_bytes=int(Xd.nbytes),
             compact_bytes=int(vc.nbytes + ic.nbytes),
             device=dev.device_kind)


if __name__ == "__main__":
    main()
