"""Multi-host wiring helper (parallel/distributed.py).

Real multi-process runs need multiple hosts; these tests pin the
single-host contracts: the unconditional `initialize()` call is a
no-op outside a cluster environment, the helpers report single-process
values, and `global_mesh` lays the (data, row) mesh over the global
device list (8 virtual CPU devices from conftest).
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np

from sparse_solvers_tpu.parallel import distributed as dist
from sparse_solvers_tpu.parallel import sharding as sh


def test_initialize_noop_on_single_host(monkeypatch):
    for v in dist._CLUSTER_ENV_VARS + ("JAX_NUM_PROCESSES",):
        monkeypatch.delenv(v, raising=False)
    assert dist.initialize() is False
    assert dist.is_initialized() is False  # nothing was started


def test_process_helpers_single_host():
    assert dist.process_index() == 0
    assert dist.process_count() == 1


def test_global_mesh_covers_all_devices():
    mesh = dist.global_mesh()
    assert mesh.shape == {"data": 1, "row": jax.device_count()}
    mesh2 = dist.global_mesh(n_data=2)
    assert mesh2.shape == {"data": 2, "row": jax.device_count() // 2}
    # the mesh composes with the sharded solvers
    rng = np.random.RandomState(0)
    A = rng.randn(16, 8).astype(np.float32)
    Y = rng.randn(2, 16).astype(np.float32)
    Ad, Yd = sh.shard_inputs(mesh2, A, Y)
    X, rep = sh.homotopy_sharded(mesh2, Ad, Yd, 0.1, 8)
    assert X.shape == (2, 8)


def test_two_process_sharded_solve_matches_single_process():
    """Real multi-process runtime: two CPU processes (4 virtual devices
    each) join one 8-device SPMD job through distributed.initialize, lay
    the (data=2, row=4) global mesh, and run a row+batch-sharded solve;
    each child asserts its addressable shards equal a locally computed
    single-process solve of the same inputs (see tests/_dist_child.py).
    This is the runtime leg the virtual-mesh tests cannot cover: an
    actual coordinator, cross-process device enumeration, and global
    arrays built per-host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    child = os.path.join(os.path.dirname(__file__), "_dist_child.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_ENABLE_X64")}
    procs = [subprocess.Popen(
        [sys.executable, child, coordinator, str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for rc, out, err in outs:
        assert rc == 0, f"child failed (rc={rc}):\n{out}\n{err}"
        assert "DIST_CHILD_OK" in out, (out, err)
