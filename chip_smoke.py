"""Smoke run of the batched sparse-recovery solvers on one GPU.

    python chip_smoke.py            # one card
    python chip_smoke.py --mesh4    # four cards of one host, one process

One card runs five phases through the public façades, at the headline
shape of bench.py (4096×8192 float32, unit-norm Gaussian columns, k=64,
batch 256, data made from --seed):

  device    platform, device_kind, count, nvidia-smi name and power limit
  kernels   each slot-space primitive (ops/slot.py) once at the headline
            widths against its reference
  main      Homotopy(precision="certified").solve_batch_on_device on the
            slot-space driver and on the vmapped core, and the driver
            with its q product on the float32 operand (the route apart
            from the bf16 product): compile time, median and p90 batch
            time, solves/s, iterations, certificate failures, the
            process's peak device memory; 4 lanes against the float64
            oracle
  omp       Omp on its slot-space driver, picks=1 and picks=4
  families  Irls, IrlsCg, Cosamp and gram-free Homotopy, one batch each

``--mesh4`` runs only the four-card phase: Homotopy(mesh=) on (1, 4) and
(2, 2) meshes, homotopy_sharded with overlap_mode psum and ppermute, and
omp_sharded, each compared lane for lane with the one-card solve.

Every phase prints one JSON line; a failed check raises. The last line is
``{"ok": true, "device": {...}}``. There is no CPU fallback: on any other
platform the script exits non-zero before running a phase. The phase
functions take their sizes as arguments so tests can drive them small.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from benchmarks._common import make_sparse_problem as make_problem

HEADLINE = dict(m=4096, n=8192, k=64, batch=256, k_max=96,
                max_iterations=128, tol=1e-2)


def emit(phase: str, **fields) -> dict:
    print(json.dumps({"phase": phase, **fields}), flush=True)
    return fields


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _support(X, thresh):
    return [set(np.flatnonzero(np.abs(x) > thresh)) for x in X]


def _timed(run, reps):
    """(compile seconds, per-batch seconds) of ``run``: the first call
    compiles, one more is discarded, then ``reps`` calls are timed, each
    fenced with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(run())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return compile_s, np.asarray(times), out


def _stats(times, batch):
    med = float(np.median(times))
    return dict(median_ms=med * 1e3,
                p90_ms=float(np.percentile(times, 90)) * 1e3,
                solves_per_s=batch / med, timed_batches=len(times))


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def device_phase() -> dict:
    import jax

    from sparse_solvers_tpu.utils.profiling import card_label

    devs = jax.devices()
    smi = card_label()
    print(smi, flush=True)
    return emit("device", platform=devs[0].platform,
                kind=devs[0].device_kind, count=len(devs),
                nvidia_smi=smi.splitlines(), jax=jax.__version__,
                xla_flags=os.environ.get("XLA_FLAGS", ""))


# --------------------------------------------------------------------------
# kernels: each slot-space primitive against its reference


def _slot_states(rng, A, b, K):
    """Valid per-lane slot states over the columns of A: between K/4 and
    K/2 live slots, the inverse of their Gram, random slot vectors."""
    m, n = A.shape
    inv = np.zeros((b, K, K), np.float32)
    gk = np.zeros((b, K, K), np.float32)
    ind = np.full((b, K), n, np.int32)
    kk = rng.integers(max(2, K // 4), max(3, K // 2), b).astype(np.int32)
    for l in range(b):
        cols = rng.choice(n, kk[l], replace=False)
        Ac = A[:, cols].astype(np.float64)
        g = Ac.T @ Ac
        gk[l, :kk[l], :kk[l]] = g
        inv[l, :kk[l], :kk[l]] = np.linalg.inv(g)
        ind[l, :kk[l]] = cols
    live_slot = np.arange(K)[None, :] < kk[:, None]
    vec = lambda: np.where(live_slot, rng.standard_normal((b, K)),
                           0).astype(np.float32)
    return inv, gk, ind, kk, vec(), vec(), vec()


def _insert_column(rng, A, ind, kk):
    """A new column per lane and its Gram entries over the live slots."""
    b, K = ind.shape
    n = A.shape[1]
    idx = np.empty(b, np.int32)
    for l in range(b):
        while True:
            j = int(rng.integers(n))
            if j not in ind[l, :kk[l]]:
                idx[l] = j
                break
    safe = np.minimum(ind, n - 1)
    a = A[:, idx].T.astype(np.float64)                       # (b, m)
    u1 = np.einsum("bm,mbk->bk", a, A[:, safe].astype(np.float64))
    u1 = np.where(ind < n, u1, 0).astype(np.float32)
    vtv = np.sum(a * a, axis=1).astype(np.float32)
    return idx, u1, vtv


def _close(name, got, ref, rtol):
    """max |got − ref| against rtol·max|ref| (per array)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref)))
    check(err <= rtol * scale, f"{name}: max err {err:.3e} > "
          f"{rtol:g}·max|ref| = {rtol * scale:.3e}")
    return err / scale


def kernels_phase(m, n, b, K, seed=0) -> dict:
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from sparse_solvers_tpu.linalg import online_inverse as oinv
    from sparse_solvers_tpu.ops import blas, slot

    rng = np.random.default_rng(seed)
    A, _, _ = make_problem(m, n, 1, 1, seed)
    out = {}

    # q product: the one-pass bf16 form against float64 on the same bf16
    # roundings. The first gemm p = D·Aᵀ is held to float64 on its own;
    # the chain to float64 on the roundings of the device's p. Against
    # float64's own roundings of p the chain is reported, not held: the
    # first gemm's float32 error moves a fraction of a percent of p's
    # bf16 roundings by one bf16 ulp (2^-8 relative), which alone shifts
    # q by more than 1e-3 of max|q| at the headline widths
    bf = lambda x: np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    D = rng.standard_normal((b, n), dtype=np.float32)
    A16 = bf(A)
    a64 = A16.astype(np.float64)
    p_ref = bf(D).astype(np.float64) @ a64.T
    A16d = jnp.asarray(A16)
    p_dev = np.asarray(jax.jit(lambda A_, D_: slot.gemm_bf16(
        D_, A_, trans_b=True))(A16d, jnp.asarray(D)))
    q_same = bf(p_dev).astype(np.float64) @ a64
    q = np.asarray(jax.jit(slot.normal_matvec_bf16)(A16d, jnp.asarray(D)),
                   np.float64)
    out["q_bf16"] = dict(
        precision="bf16 operands, bf16 intermediate, f32 accumulation",
        tolerance="p = D·Aᵀ atol 1e-4·max|ref|; q atol 1e-3·max|ref| on "
                  "the device's bf16 roundings of p",
        p_roundings_moved=float(np.mean(bf(p_dev) != bf(p_ref))),
        q_vs_float64_roundings=float(
            np.max(np.abs(q - bf(p_ref).astype(np.float64) @ a64))
            / np.max(np.abs(q_same))),
        rel_err=dict(p=_close("q_bf16 D·Aᵀ", p_dev, p_ref, 1e-4),
                     q=_close("q_bf16", q, q_same, 1e-3)))

    # the float32 two-gemm form at HIGHEST (the certificate's precision)
    def q32(A, D):
        with blas.precision_scope("highest"):
            return blas.xgemm(blas.xgemm(D, A, trans_b=True), A)
    q_ref32 = (D.astype(np.float64) @ A.T.astype(np.float64)) @ A
    out["q_f32_highest"] = dict(
        precision="float32 at HIGHEST", tolerance="atol 1e-5·max|ref|",
        rel_err=_close("q_f32_highest",
                       jax.jit(q32)(jnp.asarray(A), jnp.asarray(D)),
                       q_ref32, 1e-5))

    # γ scan: float64 reference on the same float32 inputs
    c_inf = np.ones(b, np.float32)
    c = rng.uniform(-0.9, 0.9, (b, n)).astype(np.float32)
    q = (0.5 * rng.standard_normal((b, n))).astype(np.float32)
    inv, gk, ind, kk, xa, da, ca = _slot_states(rng, A, b, K)
    mask = np.zeros((b, n), np.int8)
    np.put_along_axis(mask, np.minimum(ind, n - 1),
                      (ind < n).astype(np.int8), axis=1)
    g_dev, i_dev = map(np.asarray, jax.jit(slot.find_max_gamma)(
        *map(jnp.asarray, (q, c, mask, c_inf, xa, da, ind))))
    big = np.inf
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        tl = (1.0 - c64) / (1.0 - q64)
        tr = (1.0 + c64) / (1.0 + q64)
        ta = -xa.astype(np.float64) / da
    cand = np.where(mask > 0, big, np.minimum(
        np.where(tl > 0, tl, big), np.where(tr > 0, tr, big)))
    ta = np.where((ta > 0) & np.isfinite(ta), ta, big)
    full = np.concatenate([cand, ta], axis=1)
    pos = np.concatenate([np.broadcast_to(np.arange(n), (b, n)), ind], axis=1)
    g_ref = full.min(axis=1)
    i_ref = np.where(full == g_ref[:, None], pos, n + 1).min(axis=1)
    rel = np.abs(g_dev - g_ref) / g_ref
    # the minimizing inactive candidate has |c| ≥ 0.5, so its numerator
    # 1 ∓ c is exact in float32 (Sterbenz); its denominator and the
    # quotient are rounded once each (an active candidate's quotient
    # only), so γ is within 2^-23 relative of float64
    eps = float(np.finfo(np.float32).eps)
    check(bool(np.all(rel <= eps)), f"scan: gamma rel err {rel.max():.3e} "
          f"> {eps:.3e}")
    check(np.array_equal(i_dev, i_ref), "scan: idx differs in "
          f"{int(np.sum(i_dev != i_ref))} lanes")
    out["scan"] = dict(precision="float32 vs float64 reference",
                       tolerance="gamma rel err ≤ float32 eps (2^-23); "
                       "idx equal",
                       gamma_rel_err=float(rel.max()),
                       gamma_err_ulp=float(np.max(np.abs(g_dev - g_ref) / (
                           np.spacing(g_ref.astype(np.float32))))),
                       idx_equal=int((i_dev == i_ref).sum()),
                       active_wins=int((i_ref != np.argmin(cand, 1)).sum()))

    # transition: even lanes remove a live slot (lane 0 the last one), odd
    # lanes insert a new column, the last lane is frozen
    idx, u1, vtv = _insert_column(rng, A, ind, kk)
    rm_lane = np.arange(b) % 2 == 0
    pos_rm = np.array([kk[l] - 1 if l == 0 else rng.integers(kk[l])
                       for l in range(b)])
    idx = np.where(rm_lane, ind[np.arange(b), pos_rm], idx).astype(np.int32)
    u1 = np.where(rm_lane[:, None], 0, u1).astype(np.float32)
    vtv = np.where(rm_lane, 0, vtv).astype(np.float32)
    live = np.ones(b, bool)
    live[-1] = False
    gamma = np.where(live, rng.random(b) * 0.1, 0).astype(np.float32)
    cnew = rng.standard_normal(b).astype(np.float32)
    doins, dorm = live & ~rm_lane, live & rm_lane
    tol = np.float32(0.01)
    got = jax.jit(slot.transition, static_argnums=16)(
        *map(jnp.asarray, (inv, gk, xa, da, ca, ind, u1, idx, kk, gamma,
                           vtv, cnew, live, doins, dorm, tol)), n)
    inv2, gk2, x2, d2, ca2, ind2, deg = map(np.asarray, got)

    def st(l_inv, l_ind, l_k):
        return oinv.InverseState(inv=l_inv, indices=l_ind,
                                 mask=jnp.zeros(n, bool), k=l_k)

    @jax.jit
    def ref_ops(inv, gk, ind, kk, idx, u1, vtv, pos):
        with blas.precision_scope("highest"):
            ins = jax.vmap(lambda a, b_, c_, d_, e, f: oinv.insert_unordered(
                st(a, b_, c_), d_, e, f))(inv, ind, kk, idx, u1, vtv)
            rem = jax.vmap(lambda a, b_, c_, d_: oinv.remove_unordered(
                st(a, b_, c_), d_))(inv, ind, kk, idx)
            gk_rm = jax.vmap(oinv.swap_drop_rowcol)(gk, pos, kk - 1)
        return ins.inv, ins.indices, rem.inv, rem.indices, gk_rm

    r = list(map(np.asarray, ref_ops(*map(jnp.asarray, (
        inv, gk, ind, kk, idx, u1, vtv, pos_rm.astype(np.int32))))))
    lv = live[:, None]
    x1 = np.where(lv, xa + gamma[:, None] * da, xa).astype(np.float64)
    ca1 = np.where(lv, ca - gamma[:, None] * np.einsum(
        "bij,bj->bi", gk.astype(np.float64), da), ca)
    bi = np.arange(b)
    gk_ins = gk.astype(np.float64).copy()
    row = u1.astype(np.float64).copy()
    row[bi, kk] = vtv
    gk_ins[bi, kk, :] = row
    gk_ins[bi, :, kk] = row
    ca_ins = ca1.copy()
    ca_ins[bi, kk] = cnew
    x_rm, ca_rm = x1.copy(), ca1.copy()
    x_rm[bi, pos_rm], ca_rm[bi, pos_rm] = x1[bi, kk - 1], ca1[bi, kk - 1]
    x_rm[bi, kk - 1] = ca_rm[bi, kk - 1] = 0
    sel = lambda a_rm, a_ins, a_frz: np.where(
        dorm.reshape((-1,) + (1,) * (a_rm.ndim - 1)), a_rm,
        np.where(doins.reshape((-1,) + (1,) * (a_rm.ndim - 1)), a_ins,
                 a_frz))
    inv_ref = sel(r[2], r[0], inv)
    ind_ref = sel(r[3], r[1], ind)
    gk_ref = sel(r[4], gk_ins, gk)
    x_ref = sel(x_rm, x1, xa)
    ca_ref = sel(ca_rm, ca_ins, ca)
    sgn = np.where(ca_ref > tol, 1.0, np.where(ca_ref < -tol, -1.0, 0.0))
    d_ref = np.where(lv, np.einsum("bij,bj->bi", inv_ref, sgn), da)
    check(not deg.any(), "transition: unexpected degenerate insert")
    check(np.array_equal(ind2, ind_ref), "transition: indices differ")
    out["transition"] = dict(
        precision="float32 vs linalg/online_inverse at HIGHEST",
        tolerance="rtol 1e-4 of max|ref|",
        lanes=dict(remove=int(dorm.sum()), insert=int(doins.sum()),
                   frozen=int((~live).sum())),
        rel_err={k_: _close(f"transition {k_}", g_, r_, 1e-4)
                 for k_, g_, r_ in (("inv", inv2, inv_ref),
                                    ("gk", gk2, gk_ref), ("x", x2, x_ref),
                                    ("c_act", ca2, ca_ref),
                                    ("d", d2, d_ref))})

    # OMP insert + LS re-solve
    idx, u1, vtv = _insert_column(rng, A, ind, kk)
    b_act = np.where(np.arange(K)[None, :] <= kk[:, None],
                     rng.standard_normal((b, K)), 0).astype(np.float32)
    inv3, coef, deg = map(np.asarray, jax.jit(slot.omp_insert)(
        *map(jnp.asarray, (inv, u1, kk, vtv, b_act, live))))
    ins_inv = np.asarray(ref_ops(*map(jnp.asarray, (
        inv, gk, ind, kk, idx, u1, vtv, pos_rm.astype(np.int32))))[0])
    inv_ref = np.where(live[:, None, None], ins_inv, inv)
    coef_ref = np.einsum("bij,bj->bi", inv_ref.astype(np.float64), b_act)
    check(not deg.any(), "omp_insert: unexpected degenerate insert")
    out["omp_insert"] = dict(
        precision="float32 vs linalg/online_inverse at HIGHEST",
        tolerance="rtol 1e-4 of max|ref|",
        rel_err={"inv": _close("omp_insert inv", inv3, inv_ref, 1e-4),
                 "coef": _close("omp_insert coef", coef, coef_ref, 1e-4)})
    return emit("kernels", shape=dict(m=m, n=n, b=b, K=K), **out)


# --------------------------------------------------------------------------
# main path: the certified homotopy headline on both routes


def _route_env(driver: bool | None):
    if driver is None:
        os.environ.pop("SS_BATCH_NATIVE", None)
    else:
        os.environ["SS_BATCH_NATIVE"] = "1" if driver else "0"


def main_phase(m, n, k, batch, k_max, max_iterations, tol, reps=10,
               oracle_lanes=4, seed=0) -> dict:
    import jax

    import sparse_solvers_tpu as ss
    from sparse_solvers_tpu.api import _certified_error
    from sparse_solvers_tpu.ops import blas
    from sparse_solvers_tpu.oracle import homotopy as oracle
    from sparse_solvers_tpu.solvers import homotopy_batch as HB

    A, Xt, Y = make_problem(m, n, k, batch, seed)
    Yd = jax.device_put(Y)
    routes = {}

    def measure(name, run, **info):
        compile_s, times, (X, rep) = _timed(run, reps)
        X, it, err = map(np.asarray, (X, rep.iter, rep.solution_error))
        resid = np.max(np.abs(X.astype(np.float64) @ A.T - Y), axis=1)
        cert_fail = int(np.sum(~(err <= tol)))
        routes[name] = dict(
            **info, compile_s=compile_s, **_stats(times, batch),
            iters_mean=float(it.mean()), iters_max=int(it.max()),
            cert_failed=cert_fail, cert_max=float(err.max()),
            max_abs_AX_minus_Y=float(resid.max()),
            process_peak_bytes_in_use=_peak_bytes())
        check(cert_fail == 0, f"{name}: {cert_fail} lanes failed the "
              "certificate")
        routes[name]["_X"] = X
        routes[name]["_it"] = it

    for name, driver in (("driver", True), ("vmapped", False)):
        _route_env(driver)
        s = ss.Homotopy(A, k_max=k_max, precision="certified", engine="jax")
        plan = s.explain(batch=batch, max_iterations=max_iterations)
        check(plan["batch_native"] == driver, f"{name}: routed {plan}")
        measure(name, lambda: s.solve_batch_on_device(Yd, tol,
                                                      max_iterations),
                formulation=plan["formulation"], bf16_q=plan.get("bf16_q"))

    # the driver with its q product on the float32 operand (TF32 on the
    # card, as the vmapped core's products are) in the façade's certified
    # program otherwise: the route compared apart from the bf16 q product
    @jax.jit
    def driver_tf32(A_, G_, Y_, tol_):
        with blas.precision_scope("default"):
            X_, rep = HB.solve_homotopy_batch(A_, G_, Y_, tol_,
                                              max_iterations, k_max,
                                              bf16_q=False)
        return X_, rep._replace(solution_error=_certified_error(A_, X_, Y_))

    measure("driver_tf32", lambda: driver_tf32(s._A, s._G, Yd,
                                               np.float32(tol)),
            formulation="slot-space batch driver, q product float32 "
            "operands at DEFAULT", bf16_q=False)

    # the certificate's own cost: one fused ‖Aᵀ(y−Ax)‖∞ at HIGHEST
    Ad = jax.device_put(A)
    Xd = jax.device_put(routes["driver"]["_X"])
    cert = jax.jit(_certified_error)
    _, ct, _ = _timed(lambda: cert(Ad, Xd, Yd), reps)

    # oracle lanes in float64
    lanes = []
    for l in range(min(oracle_lanes, batch)):
        xo, _, _ = oracle.solve(A, Y[l], tol, max_iterations)
        xd = routes["driver"]["_X"][l]
        lanes.append(dict(
            lane=l, same_support=_support([xd], 1e-3) == _support([xo], 1e-3),
            exact_active_set=set(np.flatnonzero(xd)) == set(
                np.flatnonzero(xo)),
            planted_support=_support([xd], 1e-3)[0] == set(
                np.flatnonzero(Xt[l])),
            max_abs_dx=float(np.max(np.abs(xd - xo)))))
        check(lanes[-1]["same_support"],
              f"lane {l}: driver support differs from the oracle's")
    same_iters = int(np.sum(routes["driver"]["_it"]
                            == routes["vmapped"]["_it"]))
    for r in routes.values():
        del r["_X"], r["_it"]
    faster = lambda *names: min(names, key=lambda r: routes[r]["median_ms"])
    _route_env(None)
    auto = ss.Homotopy(A, k_max=k_max).explain(
        batch=batch, max_iterations=max_iterations).get("batch_native")
    return emit("main", shape=dict(m=m, n=n, k=k, batch=batch, k_max=k_max,
                                   max_iterations=max_iterations, tol=tol),
                routes=routes, lanes_same_iters=same_iters,
                certificate=dict(precision="highest", **_stats(ct, batch)),
                oracle=lanes, faster_route=faster("driver", "vmapped"),
                faster_route_tf32=faster("driver_tf32", "vmapped"),
                peak_bytes_scope="process_peak_bytes_in_use is the "
                "process's running peak: each route's covers every route "
                "and phase before it",
                auto_route="driver" if auto else "vmapped")


# --------------------------------------------------------------------------
# OMP on its slot-space driver


def omp_phase(m, n, k, batch, max_iterations, tol, picks=(1, 4), reps=10,
              seed=1) -> dict:
    import jax

    import sparse_solvers_tpu as ss

    A, Xt, Y = make_problem(m, n, k, batch, seed)
    Yd = jax.device_put(Y)
    planted = _support(Xt, 0)
    out = {}
    _route_env(True)
    for p in picks:
        s = ss.Omp(A, picks=p, engine="jax")
        plan = s.explain(batch=batch, max_iterations=max_iterations)
        check(plan["corr"] == "driver", f"omp picks={p}: routed {plan}")
        compile_s, times, (X, rep) = _timed(
            lambda: s.solve_batch_on_device(Yd, tol, max_iterations), reps)
        X, it, err = map(np.asarray, (X, rep.iter, rep.solution_error))
        exact = sum(a == b for a, b in zip(_support(X, 1e-3), planted))
        out[f"picks{p}"] = dict(compile_s=compile_s,
                                **_stats(times, batch),
                                iters_mean=float(it.mean()),
                                iters_max=int(it.max()),
                                cert_failed=int(np.sum(~(err <= tol))),
                                exact_support=exact,
                                process_peak_bytes_in_use=_peak_bytes())
        check(exact == batch, f"omp picks={p}: exact support in {exact} "
              f"of {batch} lanes")
    _route_env(None)
    return emit("omp", shape=dict(m=m, n=n, k=k, batch=batch,
                                  max_iterations=max_iterations, tol=tol),
                **out)


# --------------------------------------------------------------------------
# the other families


def families_phase(irls=(2048, 1024, 256), irls_cg=(512, 4096, 16, 64),
                   cosamp=(4096, 8192, 64, 256),
                   gram_free=(2048, 65536, 16, 256), seed=2) -> dict:
    import jax

    import sparse_solvers_tpu as ss

    out = {}

    def run(name, solve, X_true, hit):
        t0 = time.perf_counter()
        X, rep = solve()
        X = np.asarray(jax.block_until_ready(X))
        first_s = time.perf_counter() - t0
        ok = int(sum(hit(x, xt) for x, xt in zip(X, X_true)))
        out[name] = dict(first_call_s=first_s, lanes=len(X), recovered=ok,
                         iters_mean=float(np.mean(np.asarray(rep.iter))),
                         process_peak_bytes_in_use=_peak_bytes())
        check(ok == len(X), f"{name}: support recovered in {ok} of "
              f"{len(X)} lanes")

    topk = lambda x, xt: set(np.argsort(-np.abs(x))[:np.count_nonzero(xt)]) \
        == set(np.flatnonzero(xt))

    # IRLS (m ≥ n): 1-sparse detection under additive noise
    m, n, b = irls
    A, Xt, Y = make_problem(m, n, 1, b, seed)
    Y = Y + np.random.default_rng(seed).uniform(0, 0.02, Y.shape).astype(
        np.float32)
    s = ss.Irls(A, engine="jax", stabilized=True)
    run("irls_stabilized", lambda: s.solve_batch(Y, 1e-3, 50), Xt,
        lambda x, xt: np.argmax(np.abs(x)) == np.argmax(xt))

    m, n, k, b = irls_cg
    A, Xt, Y = make_problem(m, n, k, b, seed, signed=True, amp=(0.5, 1.5))
    s = ss.IrlsCg(A, k_sparsity=2 * k, cg_max_iterations=96, engine="jax")
    run("irls_cg", lambda: s.solve_batch(Y, 1e-3, 30), Xt, topk)

    m, n, k, b = cosamp
    A, Xt, Y = make_problem(m, n, k, b, seed)
    s = ss.Cosamp(A, k)
    run("cosamp", lambda: s.solve_batch(Y, 1e-3, 20), Xt, topk)

    m, n, k, b = gram_free
    A, Xt, Y = make_problem(m, n, k, b, seed)
    s = ss.Homotopy(A, gram=False, engine="jax")
    plan = s.explain(batch=b, max_iterations=2 * k)
    out["gram_free_plan"] = dict(batch_native=plan["batch_native"],
                                 gram_free=plan.get("gram_free", False))
    run("homotopy_gram_free", lambda: s.solve_batch(Y, 1e-2, 2 * k), Xt,
        lambda x, xt: set(np.flatnonzero(np.abs(x) > 0.1))
        == set(np.flatnonzero(xt)))
    return emit("families", **out)


# --------------------------------------------------------------------------
# four cards: the mesh routes against the one-card solve


def mesh4_phase(m, n, k, batch, k_max, max_iterations, tol, seed=3,
                x_atol=1e-3) -> dict:
    """Each mesh route against the one-card solve of the same problem,
    lane for lane: equal iteration counts, and X within ``x_atol`` — the
    row shards sum q in another order (psum tree or ring), which moves
    float32 rounding only."""
    import jax

    import sparse_solvers_tpu as ss
    from sparse_solvers_tpu.parallel import sharding as sh

    check(len(jax.devices()) >= 4, "mesh4 needs four devices")
    _xi = lambda out: (out[0], out[1].iter)
    A, Xt, Y = make_problem(m, n, k, batch, seed)
    Hd = ss.Homotopy(A, k_max=k_max, engine="jax")
    X1, r1 = Hd.solve_batch(Y, tol, max_iterations)
    t0 = time.perf_counter()
    X1, r1 = jax.block_until_ready(Hd.solve_batch(Y, tol, max_iterations))
    single_ms = (time.perf_counter() - t0) * 1e3
    X1, it1 = np.asarray(X1), np.asarray(r1.iter)
    Od = ss.Omp(A, engine="jax")
    Xo1, ro1 = Od.solve_batch(Y, tol, max_iterations)
    Xo1, ito1 = np.asarray(Xo1), np.asarray(ro1.iter)
    out = {}
    problems = []

    def compare(name, run, Xref, itref, extra=None):
        """``run`` returns (X, iters); its second call is timed."""
        X, it = run()
        t0 = time.perf_counter()
        X, it = jax.block_until_ready(run())
        second = (time.perf_counter() - t0) * 1e3
        X, it = np.asarray(X)[:batch], np.asarray(it)[:batch]
        dx = float(np.max(np.abs(X - Xref)))
        out[name] = dict(same_iters=int(np.sum(it == itref)),
                         lanes=len(it), max_abs_dx=dx,
                         second_call_ms=second, **(extra or {}))
        if not np.array_equal(it, itref):
            problems.append(f"{name}: iterations differ in "
                            f"{int(np.sum(it != itref))} lanes")
        if not dx <= x_atol:
            problems.append(f"{name}: max |ΔX| {dx:.3e} > {x_atol}")

    for n_data, n_row in ((1, 4), (2, 2)):
        mesh = sh.make_mesh(n_row=n_row, n_data=n_data,
                            devices=jax.devices()[:4])
        s = ss.Homotopy(A, k_max=k_max, mesh=mesh)
        plan = s.explain(batch=batch, max_iterations=max_iterations)
        shards = s._mesh_arrays()[0].addressable_shards
        compare(f"homotopy_mesh_{n_data}x{n_row}",
                lambda: _xi(s.solve_batch(Y, tol, max_iterations)), X1, it1,
                dict(batch_native=plan["batch_native"],
                     overlap_mode=plan["overlap_mode"],
                     shard_devices=len({sd.device.id for sd in shards})))
        if out[f"homotopy_mesh_{n_data}x{n_row}"]["shard_devices"] != 4:
            problems.append("A's shards do not sit on four distinct "
                            "devices")

    mesh = sh.make_mesh(n_row=4, n_data=1, devices=jax.devices()[:4])
    Am = ss.api._mesh_place_rows(mesh, A)
    Ym = ss.api._mesh_prep_batch(mesh, Y, Am.shape[0])[0]
    for mode in ("psum", "ppermute"):
        compare(f"homotopy_sharded_{mode}", lambda: _xi(sh.homotopy_sharded(
            mesh, Am, Ym, tol, max_iterations, k_max=k_max,
            precision="certified", batch_native=True, overlap_mode=mode)),
            X1, it1)
    compare("omp_sharded", lambda: _xi(sh.omp_sharded(
        mesh, Am, Ym, tol, max_iterations, precision="certified")),
        Xo1, ito1)
    out = emit("mesh4", shape=dict(m=m, n=n, k=k, batch=batch,
                                   k_max=k_max, tol=tol),
                x_atol=x_atol, single_card_second_call_ms=single_ms,
                x_atol_reason="row shards sum q in another order (psum "
                "tree or ppermute ring): float32 rounding only",
                **out)
    check(not problems, "; ".join(problems))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: default device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    import sparse_solvers_tpu  # noqa: F401  (fail before any phase runs)

    h = HEADLINE
    device_phase()
    if args.mesh4:
        mesh4_phase(h["m"], h["n"], h["k"], h["batch"], h["k_max"],
                    h["max_iterations"], h["tol"], seed=args.seed)
    else:
        kernels_phase(h["m"], h["n"], h["batch"], h["k_max"],
                      seed=args.seed)
        main_phase(h["m"], h["n"], h["k"], h["batch"], h["k_max"],
                   h["max_iterations"], h["tol"], reps=args.reps,
                   seed=args.seed)
        omp_phase(h["m"], h["n"], h["k"], h["batch"], h["max_iterations"],
                  h["tol"], reps=args.reps, seed=args.seed + 1)
        families_phase(seed=args.seed + 2)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
