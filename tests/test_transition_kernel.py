"""Unit tests for the slot-space transition (ops/slot.py transition)
against the linalg/online_inverse reference ops — insert, remove (both
pos≠last and the pos==last drop, which needs no slot move), frozen lanes,
and the slot-space recurrences.

Reference: src/linalg/online_inverse.h:184-293 (insert/remove update math).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sparse_solvers_tpu.ops import slot as T
import sparse_solvers_tpu.linalg.online_inverse as oinv


def _random_states(seed, b, K, n, m=30):
    """Valid per-lane active-set states from random SPD Grams."""
    rng = np.random.RandomState(seed)
    inv = np.zeros((b, K, K), np.float32)
    gk = np.zeros((b, K, K), np.float32)
    ind = np.full((b, K), n, np.int32)
    xa = np.zeros((b, K), np.float32)
    da = np.zeros((b, K), np.float32)
    ca = np.zeros((b, K), np.float32)
    kk = np.zeros(b, np.int32)
    As = rng.randn(b, m, n).astype(np.float32)
    for l in range(b):
        k = rng.randint(2, min(8, K))
        cols = rng.choice(n, k, replace=False)
        Ag = As[l][:, cols]
        g = Ag.T @ Ag
        inv[l, :k, :k] = np.linalg.inv(g)
        gk[l, :k, :k] = g
        ind[l, :k] = cols
        xa[l, :k] = rng.randn(k)
        da[l, :k] = rng.randn(k)
        ca[l, :k] = rng.randn(k)
        kk[l] = k
    return As, inv, gk, ind, xa, da, ca, kk


@pytest.mark.parametrize("remove_last", [False, True])
def test_transition_matches_online_inverse(remove_last):
    b, K, n = 8, 13, 50
    rng = np.random.RandomState(7 + remove_last)
    As, inv, gk, ind, xa, da, ca, kk = _random_states(1 + remove_last,
                                                      b, K, n)
    idx = np.zeros(b, np.int32)
    pres = np.zeros(b, bool)
    u1 = np.zeros((b, K), np.float32)
    vtv = np.zeros(b, np.float32)
    for l in range(b):
        if l % 2 == 0:  # remove lanes
            slot = kk[l] - 1 if remove_last else rng.randint(kk[l])
            idx[l] = ind[l, slot]
            pres[l] = True
        else:           # insert lanes
            free = [c for c in range(n) if c not in ind[l, :kk[l]]]
            idx[l] = free[rng.randint(len(free))]
            G = As[l].T @ As[l]
            u1[l] = np.where(ind[l] < n, G[idx[l], np.minimum(ind[l], n - 1)],
                             0)
            vtv[l] = G[idx[l], idx[l]]
    live = np.ones(b, bool)
    live[b - 1] = False  # frozen lane keeps state bit-stable
    gamma = (rng.rand(b) * 0.1).astype(np.float32)
    gamma[b - 1] = 0
    cnew = rng.randn(b).astype(np.float32)
    tol = np.float32(0.01)
    doins = live & ~pres & (kk < K)
    dorm = live & pres

    inv2, gk2, x2, d2, ca2, ind2, deg2 = map(np.asarray, T.transition(
        jnp.asarray(inv), jnp.asarray(gk), jnp.asarray(xa), jnp.asarray(da),
        jnp.asarray(ca), jnp.asarray(ind), jnp.asarray(u1),
        jnp.asarray(idx), jnp.asarray(kk), jnp.asarray(gamma),
        jnp.asarray(vtv), jnp.asarray(cnew), jnp.asarray(live),
        jnp.asarray(doins), jnp.asarray(dorm), tol, n))

    for l in range(b):
        st = oinv.InverseState(inv=jnp.asarray(inv[l]),
                               indices=jnp.asarray(ind[l]),
                               mask=jnp.zeros(n, bool), k=jnp.int32(kk[l]))
        q_act = gk[l] @ da[l]
        if not live[l]:
            ref_inv, ref_gk = inv[l], gk[l]
            ref_ind, ref_x, ref_ca = ind[l], xa[l], ca[l]
        else:
            x1 = xa[l] + gamma[l] * da[l]
            ca1 = ca[l] - gamma[l] * q_act
            if pres[l]:
                pos = int(np.argmax(ind[l] == idx[l]))
                last = int(kk[l] - 1)
                st2 = oinv.remove_unordered(st, jnp.int32(idx[l]))
                ref_inv, ref_ind = np.asarray(st2.inv), np.asarray(st2.indices)
                ref_gk = np.asarray(oinv.swap_drop_rowcol(
                    jnp.asarray(gk[l]), pos, last))
                ref_x, ref_ca = x1.copy(), ca1.copy()
                ref_x[pos] = x1[last]; ref_x[last] = 0
                ref_ca[pos] = ca1[last]; ref_ca[last] = 0
            else:
                st2 = oinv.insert_unordered(st, jnp.int32(idx[l]),
                                            jnp.asarray(u1[l]),
                                            jnp.float32(vtv[l]))
                ref_inv, ref_ind = np.asarray(st2.inv), np.asarray(st2.indices)
                ref_gk = gk[l].copy()
                r = u1[l].copy(); r[kk[l]] = vtv[l]
                ref_gk[kk[l], :] = r; ref_gk[:, kk[l]] = r
                ref_x = x1
                ref_ca = ca1.copy(); ref_ca[kk[l]] = cnew[l]
        sgn = np.where(ref_ca > tol, 1, np.where(ref_ca < -tol, -1, 0))
        ref_d = (ref_inv @ sgn.astype(np.float32)) if live[l] else da[l]

        np.testing.assert_allclose(inv2[l], ref_inv, atol=3e-5)
        np.testing.assert_allclose(gk2[l], ref_gk, atol=1e-5)
        np.testing.assert_array_equal(ind2[l], ref_ind)
        np.testing.assert_allclose(x2[l], ref_x, atol=1e-6)
        np.testing.assert_allclose(ca2[l], ref_ca, atol=1e-5)
        np.testing.assert_allclose(d2[l], ref_d, atol=3e-5)
        # no dust outside the live block (the pos==last drop bug)
        dead = ind2[l] >= n
        assert np.abs(inv2[l][dead]).max(initial=0) == 0
        assert np.abs(gk2[l][dead]).max(initial=0) == 0


def test_scan_kernel_matches_core_formula():
    """slot.find_max_gamma vs the vmapped core candidate formula,
    including leftmost tie-breaks and the all-invalid fallback
    (reference: homotopy-cpu.cpp:100-164)."""
    from sparse_solvers_tpu.solvers.homotopy import _find_max_gamma

    rng = np.random.RandomState(11)
    b, n, K = 6, 200, 9
    q = rng.randn(b, n).astype(np.float32)
    c = rng.randn(b, n).astype(np.float32)
    c[1, 20] = c[1, 30]  # engineered exact tie among inactive candidates
    q[1, 20] = q[1, 30]
    c_inf = np.abs(c).max(axis=1).astype(np.float32)
    mask = np.zeros((b, n), np.int8)
    ind = np.full((b, K), n, np.int32)
    xa = np.zeros((b, K), np.float32)
    da = np.zeros((b, K), np.float32)
    for l in range(b - 1):
        k = rng.randint(1, K)
        cols = rng.choice(n, k, replace=False)
        mask[l, cols] = 1
        ind[l, :k] = cols
        xa[l, :k] = rng.randn(k)
        da[l, :k] = rng.randn(k)
    # lane b-1: all candidates invalid -> gamma = FLT_MAX, idx = 0
    q[b - 1] = 0
    c[b - 1] = 0
    c_inf[b - 1] = 0

    g, i = T.find_max_gamma(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask),
        jnp.asarray(c_inf), jnp.asarray(xa), jnp.asarray(da),
        jnp.asarray(ind))

    for l in range(b):
        x_n = np.zeros(n, np.float32)
        d_n = np.zeros(n, np.float32)
        live = ind[l] < n
        x_n[ind[l][live]] = xa[l][live]
        d_n[ind[l][live]] = da[l][live]
        gc, ic = _find_max_gamma(jnp.asarray(q[l]), jnp.asarray(c[l]),
                                 jnp.asarray(x_n), jnp.asarray(d_n),
                                 jnp.asarray(c_inf[l]),
                                 jnp.asarray(mask[l] > 0), jnp.float32)
        assert int(i[l]) == int(ic), f"lane {l}: idx {int(i[l])} != {int(ic)}"
        np.testing.assert_allclose(float(g[l]), float(gc), rtol=1e-6)


def test_degenerate_insert_flags_and_freezes_lane():
    """Inserting a column already in span(A_Γ) makes the Schur
    complement den = vᵀv − u1ᵀBu1 rounding noise; the reference divides
    by it unguarded (online_inverse.h:219) and degenerates to inf. The
    transition must flag the lane (deg) and leave its state untouched so the
    driver can break it cleanly."""
    K, n = 4, 8
    # two orthonormal active columns -> gk = I2 (padded), inv = I2
    inv = np.zeros((2, K, K), np.float32)
    gk = np.zeros((2, K, K), np.float32)
    for l in range(2):
        inv[l, 0, 0] = inv[l, 1, 1] = 1.0
        gk[l, 0, 0] = gk[l, 1, 1] = 1.0
    xa = np.zeros((2, K), np.float32); xa[:, 0] = 0.5
    da = np.zeros((2, K), np.float32); da[:, 0] = 1.0
    ca = np.zeros((2, K), np.float32); ca[:, 0] = 0.3
    ind = np.full((2, K), n, np.int32)
    ind[:, 0] = 0; ind[:, 1] = 1
    kk = np.full(2, 2, np.int32)
    idx = np.full(2, 5, np.int32)
    # lane 0: inserted column == active column 0 (u1 = [1,0], vtv = 1:
    # den = 0, degenerate). lane 1: orthogonal column (u1 = 0, den = 1).
    u1 = np.zeros((2, K), np.float32)
    u1[0, 0] = 1.0
    vtv = np.ones(2, np.float32)
    gamma = np.full(2, 0.25, np.float32)
    cnew = np.full(2, 0.7, np.float32)
    live = np.ones(2, bool)
    doins = np.ones(2, bool)
    dorm = np.zeros(2, bool)

    inv2, gk2, x2, d2, ca2, ind2, deg = map(np.asarray, T.transition(
        *map(jnp.asarray, (inv, gk, xa, da, ca, ind, u1, idx, kk, gamma,
                           vtv, cnew, live, doins, dorm)),
        np.float32(0.01), n))

    assert bool(deg[0]) and not bool(deg[1])
    # degenerate lane: state untouched (no gamma step, no insert)
    np.testing.assert_array_equal(inv2[0], inv[0])
    np.testing.assert_array_equal(gk2[0], gk[0])
    np.testing.assert_array_equal(x2[0], xa[0])
    np.testing.assert_array_equal(ind2[0], ind[0])
    # healthy lane: insert applied at slot 2, all state finite
    assert ind2[1, 2] == 5 and np.isfinite(inv2[1]).all()
    np.testing.assert_allclose(x2[1, 0], 0.75, atol=1e-6)
