"""Factorization benchmarks — replicates the reference's linalg harnesses.

Reference: src/linalg/qr_decomposition_bench.cpp:13-55 (Householder QR and
prefactored least-squares solve, square M ∈ {32 … 2048} ×2 steps) and
src/linalg/cholesky_decomposition_bench.cpp:13-31 (Cholesky of SPD
noise·noiseᵀ, same sizes), float32.

Engines: the default JAX device (XLA's blocked factorizations — the fast
path the solvers use) and the framework's explicit Householder component
(linalg/qr.py) at small sizes.

One JSON line per (bench, m): {"bench": ..., "m": ..., "ms": ...}

Run: python benchmarks/bench_linalg.py [--quick]
"""

from __future__ import annotations

import argparse
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import sys
import time

import numpy as np


_EMPTY_MS = None  # measured harness overhead (dispatch + scalar read)


def _time(fn, *args, reps=100):
    """ms/op: run the traceable ``fn(*args)`` ``reps`` times inside ONE
    jitted fori_loop (chaining a scalar so iterations cannot be elided
    or overlapped away), fence by materializing the scalar on the host,
    and subtract the measured empty-loop harness overhead — per-op
    dispatch cost stays out of the number."""
    global _EMPTY_MS
    import jax
    import jax.numpy as jnp
    from jax import lax

    def chained(body_fn):
        def wrapped(*a):
            def body(i, s):
                perturbed = [x + s * 0 if (hasattr(x, "dtype")
                                           and jnp.issubdtype(x.dtype,
                                                              jnp.floating))
                             else x for x in a]
                out = body_fn(*perturbed)
                leaf = jax.tree_util.tree_leaves(out)[0]
                return s + jnp.ravel(leaf)[0].astype(jnp.float32) * 1e-30
            return lax.fori_loop(0, reps, body, jnp.float32(0))
        return jax.jit(wrapped)

    if _EMPTY_MS is None:
        empty = chained(lambda *a: jnp.float32(1))
        float(np.asarray(empty()))
        t0 = time.time()
        float(np.asarray(empty()))
        _EMPTY_MS = (time.time() - t0) * 1e3

    w = chained(fn)
    float(np.asarray(w(*args)))  # compile + warm
    t0 = time.time()
    float(np.asarray(w(*args)))  # fenced: the scalar reaches the host
    total = (time.time() - t0) * 1e3
    return max(total - _EMPTY_MS, 0.0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sparse_solvers_tpu.linalg import qr as ssqr
    from sparse_solvers_tpu.linalg import cholesky as sschol

    sizes = [32, 128, 512] if args.quick else [32, 64, 128, 256, 512, 1024,
                                               2048]

    qr_fn = jax.jit(lambda a: jnp.linalg.qr(a, mode="reduced"))
    chol_fn = jax.jit(sschol.cholesky_spd)
    ls_fn = jax.jit(lambda q, r, b: jax.scipy.linalg.solve_triangular(
        r, q.T @ b, lower=False))

    for m in sizes:
        rng = np.random.RandomState(m)
        A = jnp.asarray(rng.randn(m, m).astype(np.float32))
        b = jnp.asarray(rng.randn(m).astype(np.float32))
        noise = rng.randn(m, m).astype(np.float32)
        spd = jnp.asarray(noise @ noise.T + m * np.eye(m, dtype=np.float32))

        print(json.dumps({"bench": "qr_decomposition", "m": m,
                          "ms": round(_time(qr_fn, A), 4)}),
              flush=True)
        Q, R = qr_fn(A)
        print(json.dumps({"bench": "qr_solve", "m": m,
                          "ms": round(_time(ls_fn, Q, R, b), 4)}),
              flush=True)
        print(json.dumps({"bench": "cholesky_decomposition", "m": m,
                          "ms": round(_time(lambda s_: chol_fn(s_)[0],
                                            spd), 4)}),
              flush=True)
        if m <= 256:  # explicit Householder component (parity path)
            print(json.dumps({"bench": "qr_householder_explicit", "m": m,
                              "ms": round(_time(
                                  lambda a: ssqr.householder_factor(a)[0],
                                  A), 4)}),
                  flush=True)

    # mesh-native CholeskyQR2 (parallel/sharding.qr_sharded) on a
    # 1-device mesh: the construction-time QR the sharded IRLS façade
    # uses — on one chip this measures the pure Gram→Cholesky→gemm
    # formulation against XLA's blocked Householder qr above (tall
    # shapes: the IRLS regime m ≥ n)
    from sparse_solvers_tpu.parallel import sharding as sh
    mesh1 = sh.make_mesh(n_row=1, n_data=1, devices=jax.devices()[:1])
    tall = [(512, 128), (2048, 512)] if args.quick else [
        (512, 128), (2048, 512), (4096, 1024), (8192, 2048)]
    for (m, n) in tall:
        rng = np.random.RandomState(m + n)
        At = jnp.asarray(rng.randn(m, n).astype(np.float32))
        qr2 = sh._qr_sharded_fn(mesh1, 2)  # the jitted shard_map body
        print(json.dumps({"bench": "qr_sharded_choleskyqr2", "m": m,
                          "n": n,
                          "ms": round(_time(lambda a: qr2(a)[0], At), 4)}),
              flush=True)
        print(json.dumps({"bench": "qr_blocked_householder", "m": m,
                          "n": n,
                          "ms": round(_time(
                              lambda a: jnp.linalg.qr(
                                  a, mode="reduced")[0], At), 4)}),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
