"""Multi-device scaling evidence — row-sharded homotopy over a mesh.

The reference has no distributed mode (SURVEY.md §2.4); this records the
framework's scaling design evidence (VERDICT round-1 item 3):

  1. strong scaling over the row axis (devices 1→N, fixed problem);
  2. data-axis scaling (batch parallel, replicated A);
  3. sharded-on-1-device vs the unsharded batch path (sharding overhead);
  4. the gram=False regime (config-5 proxy: n too large to replicate
     AᵀA — every insert pays a psum'd Gram-column product);
  5. the collective-overlap experiment: `overlap_split` issues one psum
     per correlation column block so XLA can overlap each collective
     with the next block's local gemv; results must be identical and the
     compiled HLO shows the split collectives;
  6. (axis "batch_native") the slot-space driver inside
     shard_map — 1-device-mesh vs full-mesh rates and cross-mesh result
     parity, gram and gram-free.

On this workspace the mesh is 8 virtual CPU devices
(``--cpu`` + XLA_FLAGS=--xla_force_host_platform_device_count=8): the
timings exercise the real shard_map/collective machinery but NOT a real
interconnect — wall-clock overlap of collectives cannot be validated on host
threads, so experiment 5 records result-parity and the collective count,
with timing noted as indicative only. One JSON line per measurement.

Run:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/bench_scaling.py --cpu [--quick]

(--cpu selects the CPU through jax.config, which holds even where a
platform plugin registered itself first.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def emit(**kw):
    print(json.dumps(kw), flush=True)


def _problem(m, n, k, batch, seed=0):
    # shared ensemble; identical RNG stream to the originally recorded
    # rows (unsigned amplitudes, amp=(0.5, 1.0))
    from benchmarks._common import make_sparse_problem
    A, _, Y = make_sparse_problem(m, n, k, batch, seed=seed)
    return A, Y


def _time_sharded(jax, sh, mesh, A, Y, tol, max_iter, **kw):
    Ad, Yd = sh.shard_inputs(mesh, A, Y)
    run = jax.jit(lambda a, y: sh.homotopy_sharded(
        mesh, a, y, tolerance=tol, max_iterations=max_iter, **kw))
    Xs, rep = run(Ad, Yd)
    np.asarray(rep.iter)  # fence (compile run discarded)
    t0 = time.time()
    Xs, rep = run(Ad, Yd)
    iters = np.asarray(rep.iter)
    dt = time.time() - t0
    return dt, Xs, iters, run, (Ad, Yd)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU platform (virtual device mesh)")
    ap.add_argument("--axes", default="row,data,overhead,gram_false,"
                    "batch_native,overlap,ppermute", help="comma-separated axis subset — on a "
                    "single real chip, 'row,overhead' records the "
                    "sharded-vs-unsharded overhead without paying the "
                    "remote compiles of the other legs")
    args = ap.parse_args()
    axes = set(args.axes.split(","))

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from sparse_solvers_tpu.parallel import sharding as sh
    import sparse_solvers_tpu as ss

    m, n, k, batch = ((256, 512, 8, 8) if args.quick
                      else (2048, 4096, 32, 32))
    max_iter, tol = 2 * k, 1e-2
    A, Y = _problem(m, n, k, batch, seed=0)
    ndev = len(jax.devices())
    platform = jax.devices()[0].platform

    # --- 1. strong scaling over the row axis ---------------------------
    base = None
    d = 1
    while d <= ndev and "row" in axes:
        mesh = sh.make_mesh(n_row=d, n_data=1, devices=jax.devices()[:d])
        dt, _, iters, _, _ = _time_sharded(jax, sh, mesh, A, Y, tol,
                                           max_iter)
        sps = batch / dt
        if base is None:
            base = sps
        emit(bench="scaling", axis="row", platform=platform, devices=d,
             mesh=f"(data=1, row={d})", solves_per_sec=round(sps, 3),
             efficiency_vs_1dev=round(sps / (base * d), 3),
             mean_iterations=float(np.mean(iters)))
        d *= 2

    # --- 2. data-axis scaling ------------------------------------------
    d = 2
    while d <= ndev and "data" in axes:
        mesh = sh.make_mesh(n_row=1, n_data=d, devices=jax.devices()[:d])
        dt, _, _, _, _ = _time_sharded(jax, sh, mesh, A, Y, tol, max_iter)
        sps = batch / dt
        emit(bench="scaling", axis="data", platform=platform, devices=d,
             mesh=f"(data={d}, row=1)", solves_per_sec=round(sps, 3),
             efficiency_vs_1dev=round(sps / (base * d), 3))
        d *= 2

    # --- 3. sharded-on-1-device vs unsharded batch path ----------------
    # (requires the row axis for the sharded-1dev base rate)
    if "overhead" in axes and base is not None:
        solver = ss.Homotopy(A, engine="jax")
        Xb, rb = solver.solve_batch(Y, tolerance=tol,
                                    max_iterations=max_iter)
        np.asarray(rb.iter)
        t0 = time.time()
        Xb, rb = solver.solve_batch(Y, tolerance=tol,
                                    max_iterations=max_iter)
        np.asarray(rb.iter)
        dt_plain = time.time() - t0
        emit(bench="scaling", axis="overhead", platform=platform,
             unsharded_solves_per_sec=round(batch / dt_plain, 3),
             sharded_1dev_solves_per_sec=round(base, 3),
             sharding_overhead=round(
                 dt_plain and (batch / base) / dt_plain, 3))

    # --- 4. gram=False large-n regime (config-5 proxy) ------------------
    if "gram_false" in axes:
        mg, ng, kg, bg = ((512, 2048, 8, 4) if args.quick
                          else (4096, 16384, 16, 8))
        Ag, Yg = _problem(mg, ng, kg, bg, seed=1)
        mesh = sh.make_mesh(n_row=ndev, n_data=1)
        dt, Xg, iters, _, _ = _time_sharded(jax, sh, mesh, Ag, Yg, tol,
                                            2 * kg, gram=False)
        rec = float(np.max(np.abs(np.asarray(Xg) @ Ag.T - Yg)))
        emit(bench="scaling", axis="gram_false", platform=platform,
             devices=ndev, m=mg, n=ng, k=kg, batch=bg,
             solves_per_sec=round(bg / dt, 3),
             mean_iterations=float(np.mean(iters)),
             max_residual=round(rec, 4))

    # --- 4b. slot-space driver inside shard_map -------------------------
    # (round-3: the throughput driver runs sharded; this records its
    # sharded-vs-unsharded overhead on 1 device and its row-axis run on
    # the full mesh, gram and gram-free)
    if "batch_native" in axes:
        for gram_flag, label in ((True, "gram"), (False, "gram_free")):
            mesh1 = sh.make_mesh(n_row=1, n_data=1,
                                 devices=jax.devices()[:1])
            dt1, X1, it1, _, _ = _time_sharded(
                jax, sh, mesh1, A, Y, tol, max_iter,
                batch_native=True, gram=gram_flag)
            meshN = sh.make_mesh(n_row=ndev, n_data=1)
            dtN, XN, itN, _, _ = _time_sharded(
                jax, sh, meshN, A, Y, tol, max_iter,
                batch_native=True, gram=gram_flag)
            same = bool(np.allclose(np.asarray(X1), np.asarray(XN),
                                    atol=1e-5))
            emit(bench="scaling", axis=f"batch_native_{label}",
                 platform=platform, devices_full_mesh=ndev,
                 sharded_1dev_solves_per_sec=round(batch / dt1, 3),
                 sharded_ndev_solves_per_sec=round(batch / dtN, 3),
                 results_match_across_meshes=same,
                 mean_iterations=float(np.mean(it1)))

    # --- 5. collective-overlap experiment -------------------------------
    if "overlap" in axes:
        mesh = sh.make_mesh(n_row=min(4, ndev), n_data=1)
        dt1, X1, _, run1, sargs = _time_sharded(jax, sh, mesh, A, Y, tol,
                                                max_iter, gram=False,
                                                overlap_split=1)
        dt2, X2, _, run2, _ = _time_sharded(jax, sh, mesh, A, Y, tol,
                                            max_iter, gram=False,
                                            overlap_split=2)
        same = bool(np.allclose(np.asarray(X1), np.asarray(X2),
                                atol=1e-5))
        hlo1 = run1.lower(*sargs).compile().as_text()
        hlo2 = run2.lower(*sargs).compile().as_text()
        ar1 = hlo1.count("all-reduce")
        ar2 = hlo2.count("all-reduce")
        emit(bench="scaling", axis="overlap_split", platform=platform,
             devices=min(4, ndev),
             split1_solves_per_sec=round(batch / dt1, 3),
             split2_solves_per_sec=round(batch / dt2, 3),
             results_match=same, all_reduce_ops_split1=ar1,
             all_reduce_ops_split2=ar2,
             note=("virtual CPU mesh: timings indicative only; real "
                   "overlap requires >=2 physical devices"
                   if platform == "cpu" else "real devices"))

    # --- 5b. ppermute collective-matmul ring --------------------------
    # the hand-pipelined reduction the all-reduce combiner cannot merge;
    # on real multi-device hardware this axis is THE overlap measurement
    if "ppermute" in axes and ndev >= 2:
        meshP = sh.make_mesh(n_row=min(4, ndev), n_data=1)
        dtp, Xp, itp, runp, pargs = _time_sharded(
            jax, sh, meshP, A, Y, tol, max_iter,
            batch_native=True, gram=False, overlap_mode="ppermute")
        dts, Xs2, _, runs_, _ = _time_sharded(
            jax, sh, meshP, A, Y, tol, max_iter,
            batch_native=True, gram=False, overlap_mode="psum")
        same = bool(np.allclose(np.asarray(Xp), np.asarray(Xs2),
                                atol=1e-5))
        hlop = runp.lower(*pargs).compile().as_text()
        emit(bench="scaling", axis="ppermute_ring", platform=platform,
             devices=min(4, ndev),
             ppermute_solves_per_sec=round(batch / dtp, 3),
             psum_solves_per_sec=round(batch / dts, 3),
             results_match=same,
             collective_permutes=hlop.count("collective-permute-start(")
             or len([l for l in hlop.splitlines()
                     if "collective-permute(" in l]),
             note=("virtual CPU mesh: timings indicative only; the ring "
                   "pays CPU thread rendezvous per permute — real "
                   "overlap requires >=2 physical devices"
                   if platform == "cpu" else "real devices"))


if __name__ == "__main__":
    sys.exit(main())
