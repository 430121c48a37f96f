"""Plain-versus-hand A/B harness for the slot-space primitives, on the GPU.

Times each primitive of the slot-space drivers (sparse_solvers_tpu/ops/
slot.py) as XLA compiles it, at the headline widths (m=4096, n=8192,
K=96; b=256 and b=8). A hand-written candidate is timed here beside the
plain form it would replace before it may enter the package. Each row
gives:

  * wall_us   — host clock over ``--reps`` back-to-back calls, fenced once
                with block_until_ready (dispatch overlaps the device);
  * device_us — the sum of the device events of one call, from a
                jax.profiler trace of ``--trace-reps`` calls;
  * kernels   — device events per call (how many fusions, gemms and
                copies XLA made of the primitive) and the costliest ones;
  * share     — the least time the card could take (the larger of the
                FLOP bound and the byte bound, from the shapes, against the
                peaks of utils/profiling.CHIPS) over device_us.

Two reference rows measure what a large bf16 matmul and a large copy
reach on this card, so a share can be read against what is reachable.

    python benchmarks/bench_kernels.py [--quick] [--out FILE]

Needs a GPU (exits otherwise).
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _trace_device(fn, args, reps):
    """(device µs per call, events per call, top events) of ``fn`` from
    a profiler trace of ``reps`` calls: every event on the GPU planes'
    lines, summed."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
        (path,) = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True)
        prof = ProfileData.from_file(path)
    total = 0
    count = 0
    by_name: dict[str, float] = {}
    lines = set()
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            lines.add(line.name)
            for ev in line.events:
                total += ev.duration_ns
                count += 1
                by_name[ev.name] = by_name.get(ev.name, 0) + ev.duration_ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (total / reps / 1e3, count / reps,
            [(k[:80], v / reps / 1e3) for k, v in top], sorted(lines))


def _wall(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--trace-reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from sparse_solvers_tpu.ops import blas, slot
    from sparse_solvers_tpu.utils import profiling
    from sparse_solvers_tpu.utils.config import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("bench_kernels: needs a GPU", file=sys.stderr)
        return 1
    use_compile_cache()
    chip = profiling.detect_chip()
    smi = profiling.card_label()
    out_f = open(args.out, "a") if args.out else None

    def emit(**row):
        row = dict(device=dev.device_kind, nvidia_smi=smi, **row)
        print(json.dumps(row), flush=True)
        if out_f:
            out_f.write(json.dumps(row) + "\n")

    def measure(name, fn, fargs, flops, bytes_, peak="bf16", **extra):
        fn = jax.jit(fn)
        wall = _wall(fn, fargs, args.reps)
        dev_us, per_call, top, lines = _trace_device(fn, fargs,
                                                     args.trace_reps)
        bound_us = max(flops / (chip.peak_tflops(peak) * 1e12),
                       bytes_ / (chip.hbm_gbps * 1e9)) * 1e6
        emit(op=name, wall_us=wall, device_us=dev_us,
             kernels_per_call=per_call, top_kernels=top,
             bound_us=bound_us,
             bound="flops" if flops / (chip.peak_tflops(peak) * 1e12)
             > bytes_ / (chip.hbm_gbps * 1e9) else "bytes",
             share=bound_us / dev_us if dev_us else None,
             stream_lines=lines, **extra)
        return dev_us

    m, n, K = (1024, 2048, 48) if args.quick else (4096, 8192, 96)
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((m, n), dtype=np.float32))
    A16 = A.astype(jnp.bfloat16)

    # what this card reaches: a large bf16 matmul and a large copy
    S = 8192
    X = jnp.asarray(rng.standard_normal((S, S), dtype=np.float32)
                    ).astype(jnp.bfloat16)
    measure("reference_bf16_matmul_8192", lambda x: jnp.dot(
        x, x, preferred_element_type=jnp.float32), (X,), 2 * S ** 3,
        3 * S * S * 2)
    big = jnp.zeros((1 << 28,), jnp.float32)                    # 1 GiB
    measure("reference_copy_1GiB", lambda x: x + 1, (big,), 0,
            2 * big.size * 4)
    del X, big

    b = 256
    q = jnp.asarray(0.5 * rng.standard_normal((b, n), dtype=np.float32))
    c = jnp.asarray(rng.uniform(-0.9, 0.9, (b, n)).astype(np.float32))
    mask = jnp.zeros((b, n), jnp.int8).at[:, :K // 2].set(1)
    cinf = jnp.ones((b,), jnp.float32)
    ind = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32), (b, K))
    xa = jnp.asarray(rng.standard_normal((b, K), dtype=np.float32))
    da = jnp.asarray(rng.standard_normal((b, K), dtype=np.float32))
    measure("scan_plain_b256", slot.find_max_gamma,
            (q, c, mask, cinf, xa, da, ind), 12 * b * n, 9 * b * n,
            peak="highest", bytes_model="q, c f32 + mask int8 read once")

    inv = jnp.asarray(np.broadcast_to(np.eye(K, dtype=np.float32),
                                      (b, K, K)).copy())
    kk = jnp.full((b,), K // 2, jnp.int32)
    u1 = jnp.where(jnp.arange(K) < K // 2, 0.01, 0.0) * jnp.ones((b, K))
    vtv = jnp.full((b,), 1.0)
    live = jnp.ones((b,), bool)
    idx = jnp.full((b,), n - 1, jnp.int32)
    doins = live.at[::2].set(False)
    dorm = ~doins
    idx = jnp.where(dorm, 3, idx)
    tr = functools.partial(slot.transition, sentinel=n)
    measure("transition_plain_b256", lambda *a: tr(*a),
            (inv, inv, xa, da, xa, ind, u1, idx, kk, q[:, 0], vtv,
             c[:, 0], live, doins, dorm, jnp.float32(0.01)),
            40 * b * K * K, 4 * b * K * K * 4, peak="highest",
            bytes_model="inv and gk read and written once")
    measure("omp_insert_plain_b256", slot.omp_insert,
            (inv, u1, kk, vtv, xa, live), 8 * b * K * K, 2 * b * K * K * 4,
            peak="highest", bytes_model="inv read and written once")
    def q32(prec):
        def f(A_, D_):
            with blas.precision_scope(prec):
                return blas.xgemm(blas.xgemm(D_, A_, trans_b=True), A_)
        return f

    for b in (256, 8):
        D = jnp.asarray(rng.standard_normal((b, n), dtype=np.float32))
        fl = 4 * b * m * n
        measure(f"q_bf16_plain_b{b}", slot.normal_matvec_bf16,
                        (A16, D), fl, m * n * 2, peak="bf16", b=b,
                        bytes_model="one bf16 pass over A")
        measure(f"q_f32_default_b{b}", q32("default"), (A, D), fl,
                m * n * 4, peak="default", b=b,
                bytes_model="one f32 pass over A")
        measure(f"q_f32_highest_b{b}", q32("highest"), (A, D), fl,
                m * n * 4, peak="highest", b=b,
                bytes_model="one f32 pass over A")

    if out_f:
        out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
