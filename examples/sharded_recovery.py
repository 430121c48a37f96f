"""Multi-device sparse recovery — row-sharded sensing matrix over a mesh.

Scales the homotopy solver past one device by partitioning the sensing
matrix's rows over the "row" mesh axis and the signal batch over the
"data" axis; each device computes partial correlations, combined by one
psum per product (docs/design.md §4, parallel/sharding.py).

Runs anywhere: with fewer than 2 accelerator devices it re-executes
itself with an 8-device virtual CPU mesh (demo mode); on a multi-GPU
host it uses the actual devices. Set SS_SHARDED_DEMO_CPU=1 to
force the CPU mesh without probing the accelerator at all.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__ if "__file__" in globals() else "."))))


def main():
    import jax

    # force CPU before any device probe (the JAX_PLATFORMS env var may
    # be overridden by a site-registered accelerator plugin; the config
    # update is authoritative — see CLAUDE.md / tests/conftest.py)
    if os.environ.get("SS_SHARDED_DEMO_CPU"):
        jax.config.update("jax_platforms", "cpu")

    if jax.device_count() < 2:
        # re-exec with a virtual 8-device CPU platform for demonstration
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        os.environ["SS_SHARDED_DEMO_CPU"] = "1"
        os.execv(sys.executable, [sys.executable] + sys.argv)

    import numpy as np
    from sparse_solvers_tpu.parallel import distributed, sharding as sh

    # multi-host pods: one unconditional call joins the JAX distributed
    # runtime (a no-op on a single host — parallel/distributed.py); the
    # mesh below then spans the *global* device list
    distributed.initialize()

    m, n, k, batch = 1024, 2048, 16, 64
    rng = np.random.RandomState(0)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X_true = np.zeros((batch, n), np.float32)
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        X_true[b, sup] = rng.uniform(0.5, 1.0, k)
    Y = X_true @ A.T

    n_dev = jax.device_count()
    n_row, n_data = (4, n_dev // 4) if n_dev % 4 == 0 else (n_dev, 1)
    mesh = sh.make_mesh(n_row=n_row, n_data=n_data)
    print(f"mesh: {n_row} row-shards x {n_data} data-shards "
          f"({jax.devices()[0].platform})")

    Ad, Yd = sh.shard_inputs(mesh, A, Y)
    X, reports = sh.homotopy_sharded(mesh, Ad, Yd, tolerance=1e-2,
                                     max_iterations=4 * k)
    X = np.asarray(X)

    support_hit = np.mean([
        set(np.flatnonzero(X[b] > 0.1)) == set(np.flatnonzero(X_true[b]))
        for b in range(batch)])
    print(f"{batch} solves of {m}x{n} (k={k}) across {n_dev} devices; "
          f"mean path length {np.asarray(reports.iter).mean():.1f}; "
          f"support recovery {100*support_hit:.0f}%")

    # the same solve through the slot-space throughput driver
    # (auto-selected on GPU meshes; forced here so the demo also
    # exercises it on the CPU mesh), gram-free as the very-large-n
    # regime would run it
    Xb, repb = sh.homotopy_sharded(mesh, Ad, Yd, tolerance=1e-2,
                                   max_iterations=4 * k,
                                   batch_native=True, gram=False)
    agree = np.allclose(np.asarray(Xb), X, atol=1e-5)
    print(f"batch-native sharded driver (gram-free): mean path length "
          f"{np.asarray(repb.iter).mean():.1f}; matches vmapped core: "
          f"{agree}")

    # round 5: the ring-pipelined reduction (lax.ppermute collective
    # matmul — the overlap XLA's all-reduce combiner cannot undo; auto
    # on sharded row axes at n >= 128*S, forced here for the demo)
    if mesh.shape[sh.ROW_AXIS] > 1:
        Xp, repp = sh.homotopy_sharded(mesh, Ad, Yd, tolerance=1e-2,
                                       max_iterations=4 * k,
                                       batch_native=True, gram=False,
                                       overlap_mode="ppermute")
        print(f"ppermute collective-matmul ring: matches psum driver: "
              f"{np.allclose(np.asarray(Xp), np.asarray(Xb), atol=1e-5)}")

    # round 5: the construct-once facade on the mesh — A placed once,
    # the replicated Gram psum'd once and cached, batch padding handled
    import sparse_solvers_tpu as ss
    solver = ss.Homotopy(A, mesh=mesh)
    Xf, repf = solver.solve_batch(Y, tolerance=1e-2,
                                  max_iterations=4 * k)
    print(f"mesh facade Homotopy(A, mesh=...): matches functional path: "
          f"{np.allclose(np.asarray(Xf), X, atol=1e-4)}; plan: "
          f"{solver.explain(batch=batch)['formulation']}")

    # round 5: IRLS on the mesh with its construction QR computed BY the
    # mesh (CholeskyQR2 — no host factorization; IRLS needs m >= n, so
    # a tall sub-dictionary)
    At = A[:, : m // 2]
    Yt = (X_true[:, : m // 2] @ At.T).astype(np.float32)
    irls = ss.Irls(At, mesh=mesh)
    Xi, repi = irls.solve_batch(Yt, tolerance=1e-3, max_iterations=30)
    print(f"mesh facade Irls (CholeskyQR2 construction, "
          f"{m}x{m // 2}): mean iters {np.asarray(repi.iter).mean():.1f}")

    # the underdetermined regime shards the other way: columns of a wide
    # A over the tensor axis, CG-IRLS replicating only m-sized iterates
    # (one psum per CG step — docs/design.md §4)
    mw, nw, kw = 96, 1024, 6
    Aw = rng.randn(mw, nw).astype(np.float32)
    Aw /= np.linalg.norm(Aw, axis=0)
    Xw = np.zeros((batch, nw), np.float32)
    for b in range(batch):
        sup = rng.choice(nw, kw, replace=False)
        Xw[b, sup] = rng.choice([-1.0, 1.0], kw) * rng.uniform(0.5, 1.5, kw)
    Yw = Xw @ Aw.T
    import jax.numpy as jnp
    Xc, repc = sh.irls_cg_sharded(mesh, jnp.asarray(Aw), jnp.asarray(Yw),
                                  tolerance=1e-4, max_iterations=40)
    Xc = np.asarray(Xc)
    hit = np.mean([
        set(np.argsort(-np.abs(Xc[b]))[:kw]) == set(np.flatnonzero(Xw[b]))
        for b in range(batch)])
    print(f"column-sharded CG-IRLS {mw}x{nw} (k={kw}): mean outer "
          f"iterations {np.asarray(repc.iter).mean():.1f}; "
          f"support recovery {100*hit:.0f}%")


if __name__ == "__main__":
    main()
