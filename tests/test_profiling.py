"""utils/profiling — roofline accounting sanity."""

import numpy as np
import jax
import jax.numpy as jnp

from sparse_solvers_tpu.utils import profiling


def test_measure_reports_consistent_rates():
    f = jax.jit(lambda x: x @ x)
    x = jnp.ones((128, 128), jnp.float32)
    r = profiling.measure(f, x, flops=2 * 128**3, bytes=3 * 128 * 128 * 4,
                          reps=3)
    assert r.seconds > 0
    np.testing.assert_allclose(r.tflops, r.flops / r.seconds / 1e12)
    np.testing.assert_allclose(r.gbps, r.bytes / r.seconds / 1e9)
    s = str(r)
    assert "TFLOP/s" in s and "GB/s" in s


def test_chip_specs_precisions():
    h100 = profiling.CHIPS["NVIDIA H100 80GB HBM3"]
    assert h100.peak_tflops("highest") == h100.fp32_tflops == 67
    assert h100.peak_tflops("high") == h100.peak_tflops("default") == 495
    assert h100.peak_tflops("bf16") == 989
    r = profiling.Roofline(seconds=1e-3, flops=1e9, bytes=1e6, chip=h100)
    frac = r.fraction_of_peak("highest")
    assert frac is not None and frac > 0
    np.testing.assert_allclose(frac, max(1.0 / 67, 1.0 / 3350))


def test_detect_chip_finds_h100():
    spec = profiling.detect_chip("NVIDIA H100 80GB HBM3")
    assert spec.name == "H100 SXM" and spec.hbm_gbps == 3350


def test_detect_chip_raises_on_unknown(monkeypatch):
    """No peak is assumed for a device the table does not know — the
    CPU test device, an H100 PCIe, or any other card."""
    import pytest

    class _Dev:
        device_kind = "NVIDIA H100 PCIe"

    monkeypatch.setattr(profiling.jax, "devices", lambda: [_Dev()])
    with pytest.raises(ValueError, match="H100 PCIe"):
        profiling.detect_chip()
    with pytest.raises(ValueError):
        profiling.detect_chip("cpu")


def test_card_label(monkeypatch):
    """The nvidia-smi query's output as is, and a label (never an
    exception) where the tool cannot run."""
    import subprocess

    class _Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or _Done())
    assert profiling.card_label() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]

    def _missing(cmd, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", _missing)
    assert profiling.card_label().startswith("nvidia-smi unavailable")


def test_trace_context_manager(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as d:
        jnp.ones(8).sum().block_until_ready()
    assert (tmp_path / "tr").exists()
