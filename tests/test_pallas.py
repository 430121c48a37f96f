"""q-product and residual-correlation forms of the slot-space drivers vs
their NumPy references.

The drivers' correlation products are plain XLA gemms: the float32
two-gemm q = (D·Aᵀ)·A and the one-pass bf16 form
(ops/slot.normal_matvec_bf16), both built by homotopy_batch.make_qprod,
and the certificate's residual correlation Aᵀ(y − Ax).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sparse_solvers_tpu.ops import slot
from sparse_solvers_tpu.solvers import homotopy_batch as HB


def _rand(shape, seed):
    return jnp.asarray(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _qprod(A, bf16_q):
    """The drivers' unsharded q product (identity psum)."""
    qprod, used, _ = HB.make_qprod(A, lambda v: v, 1, bf16_q, A.shape[1])
    assert used == bf16_q
    return qprod


@pytest.mark.parametrize("m,n,b", [(64, 128, 4), (72, 256, 5), (128, 128, 8)])
def test_normal_matvec_fused(m, n, b):
    A, D = _rand((m, n), 0), _rand((b, n), 1)
    q = _qprod(A, False)(D)
    ref = np.asarray(D) @ np.asarray(A).T @ np.asarray(A)
    np.testing.assert_allclose(np.asarray(q), ref,
                               atol=2e-4 * np.max(np.abs(ref)))


@pytest.mark.parametrize("m,n,b", [(64, 128, 4), (72, 256, 3)])
def test_residual_correlation_fused(m, n, b):
    """The certificate's residual correlation max|Aᵀ(y − Ax)| per lane."""
    from sparse_solvers_tpu.api import _certified_error

    A, X, Y = _rand((m, n), 0), _rand((b, n), 1), _rand((b, m), 2)
    c = _certified_error(A, X, Y)
    ref = (np.asarray(Y) - np.asarray(X) @ np.asarray(A).T) @ np.asarray(A)
    np.testing.assert_allclose(np.asarray(c), np.max(np.abs(ref), axis=1),
                               atol=2e-4 * np.max(np.abs(ref)))


def test_fallback_on_ineligible_shapes():
    # n not a multiple of 128: both q forms take any n, each held to its
    # own reference at the float32 bound
    import ml_dtypes

    A, D = _rand((16, 100), 0), _rand((2, 100), 1)
    ref = np.asarray(D) @ np.asarray(A).T @ np.asarray(A)
    q = _qprod(A, False)(D)
    np.testing.assert_allclose(np.asarray(q), ref,
                               atol=2e-4 * np.max(np.abs(ref)))
    # the bf16 form against the same bf16 roundings
    bf = lambda x: np.asarray(x).astype(ml_dtypes.bfloat16).astype(
        np.float32)
    ref16 = bf(bf(D) @ bf(A).T) @ bf(A)
    q16 = _qprod(A, True)(D)
    np.testing.assert_allclose(np.asarray(q16), ref16,
                               atol=2e-4 * np.max(np.abs(ref16)))


def test_fused_bf16_q_matches_default_precision_roundings():
    """normal_matvec_bf16 must reproduce the one-pass schedule's
    roundings: operands quantized to bf16, the intermediate p = D Aᵀ
    rounded to bf16 before the second product, f32 accumulation."""
    import ml_dtypes

    rng = np.random.RandomState(0)
    m, n, b = 96, 256, 8
    A = rng.randn(m, n).astype(np.float32)
    D = rng.randn(b, n).astype(np.float32)

    A16 = A.astype(ml_dtypes.bfloat16).astype(np.float32)
    D16 = D.astype(ml_dtypes.bfloat16).astype(np.float32)
    p16 = (D16 @ A16.T).astype(ml_dtypes.bfloat16).astype(np.float32)
    q_ref = p16 @ A16

    q = np.asarray(jax.jit(slot.normal_matvec_bf16)(
        jnp.asarray(A, jnp.bfloat16), jnp.asarray(D)))
    np.testing.assert_allclose(q, q_ref, rtol=1e-5, atol=1e-4)


def test_driver_fused_q_recovers():
    """The batch driver with the one-pass bf16 q product still recovers
    k-sparse signals within tolerance — on CPU this genuinely quantizes
    to bf16 (unlike the float32 path, where CPU XLA ignores the
    DEFAULT-precision hint), so recovery is the contract, not bit
    parity."""
    from functools import partial
    from sparse_solvers_tpu.ops import blas

    rng = np.random.RandomState(0)
    m, n, k, B = 256, 512, 8, 8
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((B, n), np.float32)
    for i in range(B):
        X[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1, k)
    Y = (X @ A.T).astype(np.float32)
    G = np.asarray(A.T @ A, np.float32)

    f = jax.jit(partial(HB.solve_homotopy_batch, max_iterations=24,
                        k_max=25, bf16_q=True))
    with blas.precision_scope("default"):
        Xb, Rb = f(jnp.asarray(A), jnp.asarray(G), jnp.asarray(Y), 1e-2)
    Xb = np.asarray(Xb)
    assert np.isfinite(Xb).all()
    # support recovery + certified-style residual check in f32
    c = (Y - Xb @ A.T) @ A
    conv = np.asarray(Rb.iter) < 24
    assert conv.all()
    assert (np.max(np.abs(c), axis=1)[conv] <= 1e-2).all()
    for i in range(B):
        assert set(np.flatnonzero(Xb[i] > 0.1)) == set(np.flatnonzero(X[i]))
