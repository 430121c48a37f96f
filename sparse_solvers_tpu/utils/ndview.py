"""Input normalization — the device analog of the reference's ``ndspan``.

The reference wraps raw buffers in non-owning strided views
(reference: include/ss/ndspan.h:28-165) so that NumPy slices, transposes and
column subsets work zero-copy end-to-end (reference:
bindings/python/tests/test_binding.py:31-68). Here the equivalent is a
``jax.Array``: any array-like (including non-contiguous NumPy views) is
normalized here once, placed on device, and thereafter every kernel consumes
the device-resident array. Shape/dtype validation mirrors the pybind11
binding's checks (reference: bindings/python/sparsesolvers/binding.cpp:21-37).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_SUPPORTED_DTYPES = (np.float32, np.float64)


def _device_fast_path(arr, ndim: int, dtype, dim: int | None,
                      size: int | None):
    """Return ``arr`` unchanged when it is already a conforming device
    array — np.asarray on a jax.Array would round-trip through the host,
    which matters on every solve call of a serving loop."""
    if not isinstance(arr, jax.Array) or arr.ndim != ndim:
        return None
    if dtype is not None:
        if arr.dtype != np.dtype(dtype):
            return None
    elif arr.dtype not in (np.float32, np.float64):
        # int/bf16 device arrays take the slow path so they get the same
        # promotion/validation as any other input (_resolve_dtype)
        return None
    if size is not None and arr.shape[dim] != size:
        raise ValueError(
            f"Expected axis {dim} of length {size} but got {arr.shape[dim]}"
        )
    return arr


def _dim_error(expected: int, got: int) -> ValueError:
    # Same message shape as the reference binding (binding.cpp:24-25).
    return ValueError(
        f"Unexpected number of dimensions. Expected {expected} but got {got}"
    )


def as_matrix(A, *, dtype=None) -> jnp.ndarray:
    """Normalize a 2-d array-like to a device array.

    dtype is taken from the input array (float32 or float64), mirroring how
    the reference binding selects the solver precision from the NumPy dtype
    at construction (binding.cpp:69-86).
    """
    fast = _device_fast_path(A, 2, dtype, None, None)
    if fast is not None:
        return fast
    A = np.asarray(A)
    if A.ndim != 2:
        raise _dim_error(2, A.ndim)
    dt = _resolve_dtype(A, dtype)
    return jnp.asarray(A, dtype=dt)


def as_vector(x, *, dtype=None, size: int | None = None) -> jnp.ndarray:
    """Normalize a 1-d array-like to a device array."""
    fast = _device_fast_path(x, 1, dtype, 0, size)
    if fast is not None:
        return fast
    x = np.asarray(x)
    if x.ndim != 1:
        raise _dim_error(1, x.ndim)
    if size is not None and x.shape[0] != size:
        raise ValueError(f"Expected a vector of length {size} but got {x.shape[0]}")
    dt = _resolve_dtype(x, dtype)
    return jnp.asarray(x, dtype=dt)


def as_signal_batch(Y, *, dtype=None, size: int | None = None) -> jnp.ndarray:
    """Normalize a (batch, m) array-like of signals to a device array."""
    fast = _device_fast_path(Y, 2, dtype, 1, size)
    if fast is not None:
        return fast
    Y = np.asarray(Y)
    if Y.ndim != 2:
        raise _dim_error(2, Y.ndim)
    if size is not None and Y.shape[1] != size:
        raise ValueError(
            f"Expected signals of length {size} but got {Y.shape[1]}"
        )
    dt = _resolve_dtype(Y, dtype)
    return jnp.asarray(Y, dtype=dt)


def _resolve_dtype(arr: np.ndarray, dtype):
    if dtype is not None:
        return dtype
    if arr.dtype == np.float64:
        return np.float64
    if arr.dtype == np.float32:
        return np.float32
    if np.issubdtype(arr.dtype, np.floating) or np.issubdtype(arr.dtype, np.integer):
        # Integer / other float inputs promote to float32 by default;
        # float64 only when explicitly provided (requires jax x64 mode).
        return np.float32
    raise TypeError(
        f"Unsupported dtype {arr.dtype}; expected float32 or float64"
    )
