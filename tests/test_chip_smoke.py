"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
anywhere but a GPU, and (marker ``gpu``) the slot-space parity phase at
the headline widths on the card."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def no_route_env(monkeypatch):
    """The phases set SS_BATCH_NATIVE themselves; restore it after."""
    monkeypatch.delenv("SS_BATCH_NATIVE", raising=False)


@pytest.fixture
def card():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/ on the card")


def test_smoke_refuses_cpu(capsys):
    """No CPU fallback: exit non-zero and print no result line."""
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_kernels_phase_tiny():
    out = cs.kernels_phase(64, 256, 16, 12)
    assert out["scan"]["idx_equal"] == 16
    assert set(out["transition"]["rel_err"]) == {"inv", "gk", "x",
                                                 "c_act", "d"}


def test_main_phase_tiny(no_route_env):
    out = cs.main_phase(64, 256, 6, 12, 12, 16, 1e-2, reps=2,
                        oracle_lanes=2)
    assert set(out["routes"]) == {"driver", "vmapped", "driver_tf32"}
    assert all(r["cert_failed"] == 0 for r in out["routes"].values())
    assert all(lane["same_support"] for lane in out["oracle"])
    assert out["auto_route"] == "vmapped"    # CPU: the driver is GPU-only
    assert "SS_BATCH_NATIVE" not in os.environ


def test_omp_phase_tiny(no_route_env):
    out = cs.omp_phase(64, 256, 6, 24, 16, 1e-2, reps=2)
    assert out["picks1"]["exact_support"] == 24
    assert out["picks4"]["exact_support"] == 24


def test_families_phase_tiny():
    out = cs.families_phase(irls=(128, 64, 16), irls_cg=(64, 256, 4, 8),
                            cosamp=(64, 256, 6, 8),
                            gram_free=(64, 512, 4, 16))
    for name in ("irls_stabilized", "irls_cg", "cosamp",
                 "homotopy_gram_free"):
        assert out[name]["recovered"] == out[name]["lanes"], name


def test_mesh4_phase_tiny(monkeypatch):
    """The four-card phase on four of the virtual CPU devices, with the
    slot-space driver forced as it is routed on the GPU."""
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    out = cs.mesh4_phase(256, 1024, 8, 16, 24, 32, 1e-2)
    for name in ("homotopy_mesh_1x4", "homotopy_mesh_2x2",
                 "homotopy_sharded_psum", "homotopy_sharded_ppermute",
                 "omp_sharded"):
        assert out[name]["same_iters"] == out[name]["lanes"] == 16, name
    assert out["homotopy_mesh_1x4"]["overlap_mode"] == "ppermute"
    assert out["homotopy_mesh_2x2"]["shard_devices"] == 4


def test_emit_prints_one_json_line(capsys):
    cs.emit("x", a=1)
    (line,) = capsys.readouterr().out.splitlines()
    assert json.loads(line) == {"phase": "x", "a": 1}


@pytest.mark.gpu
def test_kernels_phase_on_card(card):
    out = cs.kernels_phase(**{k: cs.HEADLINE[k] for k in ("m", "n")},
                           b=cs.HEADLINE["batch"], K=cs.HEADLINE["k_max"])
    assert out["scan"]["idx_equal"] == 256
