"""Precision-pinned dense primitives — the accelerator analog of the BLAS
wrapper.

The reference routes every dense operation through typed span overloads of a
runtime-loaded OpenBLAS (reference: src/linalg/blas_wrapper.h:99-400). Here
the operations themselves are XLA ops; what this layer pins down is the
*numerics*: every contraction runs with ``precision=HIGHEST`` by default and
an explicit ``preferred_element_type`` so float32 results on the device match
the reference's float32 CPU BLAS within its test tolerances (reference test
regime: src/solvers/test_util.h — 1e-3..1e-4 absolute).

Naming follows the reference wrapper (xgemv/xgemm/xger/xdot/xnrm2/xscal/
ixamax/xtrsv/xtrsm) so the parity mapping is one-to-one.
"""

from __future__ import annotations

import contextlib
import threading

import jax
import jax.numpy as jnp
from jax import lax

# Active contraction precision for every blas-layer matmul. On the GPU a
# float32 matmul at DEFAULT or HIGH runs on the tensor cores in TF32 (a
# 10-bit mantissa, ~1e-3 relative); only HIGHEST is full FP32. The
# slot-space drivers' one-pass route is explicitly bf16 instead: a bf16
# copy of A with float32 accumulation (ops/slot.normal_matvec_bf16). On
# the CPU every precision computes full float32. The default here is
# HIGHEST — reference-parity numerics; solvers lower it per-trace through
# precision_scope. The stack is thread-local: two solver instances tracing
# concurrently from different threads must not capture each other's
# precision.
_TLS = threading.local()

# Parity-grade precision: what the certificates of precision="certified"
# and its re-solves run at. HIGH would be TF32 on the GPU, no better than
# the path it certifies.
PARITY = "highest"


def _stack():
    st = getattr(_TLS, "prec_stack", None)
    if st is None:
        st = _TLS.prec_stack = [lax.Precision.HIGHEST]
    return st

_PRECISIONS = {
    "highest": lax.Precision.HIGHEST,
    "high": lax.Precision.HIGH,
    "default": lax.Precision.DEFAULT,
}


def current_precision() -> lax.Precision:
    return _stack()[-1]


@contextlib.contextmanager
def precision_scope(precision):
    """Set the matmul precision for ops traced within the scope.

    ``precision`` is "highest" | "high" | "default" or a lax.Precision.
    Trace-time scoped (use *inside* the jitted function so retraces pick it
    up) — the analog of the reference's runtime BLAS selection
    (blas_wrapper.cpp:39-49), except the choice is precision, not µarch.
    """
    if isinstance(precision, str):
        precision = _PRECISIONS[precision.lower()]
    st = _stack()
    st.append(precision)
    try:
        yield
    finally:
        st.pop()


def xgemv(A: jnp.ndarray, x: jnp.ndarray, *, trans: bool = False) -> jnp.ndarray:
    """y = A @ x (or Aᵀ @ x). Reference: blas_wrapper.h xgemv overloads."""
    M = A.T if trans else A
    return jnp.matmul(M, x, precision=current_precision(),
                      preferred_element_type=A.dtype)


def xgemm(A: jnp.ndarray, B: jnp.ndarray, *, trans_a: bool = False,
          trans_b: bool = False) -> jnp.ndarray:
    """C = op(A) @ op(B). Reference: blas_wrapper.h xgemm."""
    Ma = A.T if trans_a else A
    Mb = B.T if trans_b else B
    return jnp.matmul(Ma, Mb, precision=current_precision(),
                      preferred_element_type=A.dtype)


def xger(alpha, x: jnp.ndarray, y: jnp.ndarray, A: jnp.ndarray) -> jnp.ndarray:
    """A + alpha·x·yᵀ (rank-1 update). Reference: blas_wrapper.h xger."""
    return A + alpha * jnp.outer(x, y)


def xdot(x: jnp.ndarray, y: jnp.ndarray):
    """xᵀy. Reference: blas_wrapper.h xdot."""
    return jnp.vdot(x, y, precision=current_precision())


def xnrm2(x: jnp.ndarray):
    """‖x‖₂. Reference: blas_wrapper.h xnrm2."""
    return jnp.sqrt(xdot(x, x))


def xscal(alpha, x: jnp.ndarray) -> jnp.ndarray:
    """alpha·x. Reference: blas_wrapper.h xscal."""
    return alpha * x


def ixamax(x: jnp.ndarray):
    """Index of the first element with maximum |x_i|.

    Reference: blas_wrapper.h ixamax (cblas_i?amax — first occurrence wins,
    which homotopy's tie-breaking depends on, homotopy-cpu.cpp:33-44).
    """
    return jnp.argmax(jnp.abs(x))


def xtrsv(L: jnp.ndarray, b: jnp.ndarray, *, lower: bool = True,
          trans: bool = False) -> jnp.ndarray:
    """Solve op(L) x = b for triangular L. Reference: blas_wrapper.h xtrsv."""
    return jax.scipy.linalg.solve_triangular(L, b, lower=lower,
                                             trans=1 if trans else 0)


def xtrsm(R: jnp.ndarray, B: jnp.ndarray, *, lower: bool = False,
          trans: bool = False) -> jnp.ndarray:
    """Solve op(R) X = B for triangular R. Reference: blas_wrapper.h xtrsm."""
    return jax.scipy.linalg.solve_triangular(R, B, lower=lower,
                                             trans=1 if trans else 0)
