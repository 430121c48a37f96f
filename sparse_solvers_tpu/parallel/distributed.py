"""Multi-host wiring — the thin runtime layer under `parallel.sharding`.

The reference is single-process (SURVEY.md §2.4: no communication
backend; its whole "backend" story is a dlopen'd per-µarch OpenBLAS,
src/linalg/blas_wrapper.cpp:27-66). The equivalent of "pick the runtime
at startup" is JAX's distributed runtime: every host of a cluster runs
the same program, `jax.distributed.initialize()` joins
them into one single-controller SPMD job, and `jax.devices()` becomes
the *global* device list over which `sharding.make_mesh` lays the
(data, row) mesh (docs/design.md §4, multi-host deployment).

This module wraps that startup so solver programs need exactly one
call::

    from sparse_solvers_tpu.parallel import distributed, sharding
    distributed.initialize()             # no-op on a single host
    mesh = distributed.global_mesh(n_data=...)  # rows within a slice

and keeps the policy documented in docs/design.md in code: the **row**
axis (one psum per product, every iteration) is laid within a host, so
its collective stays on the host's device interconnect (NVLink on a
four-GPU host); the **data** axis (lanes never communicate) is what may
span hosts.
"""

from __future__ import annotations

import os

import jax

from . import sharding as _sharding


# set by initialize() on a successful join, so idempotency survives even
# if the private-layout probe below stops working on a future JAX
_initialized_here = False


def is_initialized() -> bool:
    """Whether the JAX distributed runtime has been initialized in this
    process (single-host single-process programs never need it)."""
    if _initialized_here:
        return True
    try:
        from jax._src import distributed as _dist
        return _dist.global_state.client is not None
    except Exception:  # pragma: no cover - internal layout drift
        return False


# Environment variables that mark a managed multi-host launch where
# jax.distributed.initialize() can autodetect its cluster configuration
# (an explicit coordinator address). Deliberately conservative: nothing
# weaker may trigger a coordinator hunt on a single host.
_CLUSTER_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def _cluster_detected() -> bool:
    if any(os.environ.get(v) for v in _CLUSTER_ENV_VARS):
        return True
    try:
        return int(os.environ.get("JAX_NUM_PROCESSES", "1") or "1") > 1
    except ValueError:
        # non-numeric launcher value ("auto", ...) — not a usable marker
        # for best-effort detection; explicit initialize() arguments are
        # the supported path there (this call must never crash a
        # single-host program, it is documented as unconditional)
        return False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               **kwargs) -> bool:
    """Join this process to the JAX distributed runtime (idempotent).

    With no arguments: initialize only when a cluster environment is
    detectable (explicit coordinator env vars, or JAX_NUM_PROCESSES > 1)
    — on a plain single host this is a no-op
    returning False, so programs can call it unconditionally.

    With explicit arguments: forwarded to ``jax.distributed.initialize``
    (coordinator_address like ``"host:port"``, plus num_processes /
    process_id), raising on failure as JAX does. Returns True when the
    runtime is (now) initialized.

    Must run before the first device use, like
    ``jax.distributed.initialize`` itself.
    """
    if is_initialized():
        return True
    explicit = (coordinator_address is not None
                or num_processes is not None or process_id is not None
                or bool(kwargs))
    global _initialized_here
    if not explicit:
        if not _cluster_detected():
            return False
        jax.distributed.initialize()
        _initialized_here = True
        return True
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kwargs)
    _initialized_here = True
    return True


def global_mesh(n_row: int | None = None, n_data: int = 1):
    """A (data, row) mesh over the *global* device list.

    Defaults follow docs/design.md's placement policy: with
    ``n_data=1`` every device joins the row axis; pass
    ``n_data=jax.process_count()`` (with default n_row) to put the
    data axis across hosts and keep each row shard's psum within a
    host's devices — `jax.devices()` orders devices
    process-major, and `make_mesh` fills the (data, row) grid
    row-major, so each data row is one process's devices.
    """
    return _sharding.make_mesh(n_row=n_row, n_data=n_data,
                               devices=jax.devices())


def process_index() -> int:
    """This host's process index (0 on single-host programs)."""
    return jax.process_index()


def process_count() -> int:
    """Number of participating processes (1 on single-host programs)."""
    return jax.process_count()
