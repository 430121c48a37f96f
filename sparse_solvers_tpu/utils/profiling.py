"""Profiling & roofline utilities.

The reference's only observability is Google-Benchmark counters
(reference: src/solvers/homotopy_bench.cpp:53); the device equivalents
are XLA profiler traces and roofline accounting against the card's peak
FLOP/s and device-memory bandwidth (SURVEY.md §5 "Tracing / profiling").
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace around a block.

    View with TensorBoard's profile plugin or xprof. Usage::

        with profiling.trace("trace_dir"):
            solver.solve_batch(Y).block_until_ready()
    """
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Published peaks of one card, dense rates without sparsity."""
    name: str
    bf16_tflops: float
    tf32_tflops: float
    fp32_tflops: float
    hbm_gbps: float

    def peak_tflops(self, precision: str) -> float:
        """Peak matmul rate for a float32 product at ``precision``
        ("highest" → FP32, "high"/"default" → TF32), or for bf16
        operands ("bf16")."""
        return {"highest": self.fp32_tflops, "high": self.tf32_tflops,
                "default": self.tf32_tflops,
                "bf16": self.bf16_tflops}[precision]


# Keyed by ``jax.Device.device_kind``. Source: NVIDIA H100 data sheet,
# SXM part, at its full 700 W power limit (a card set below it cannot
# hold its top clock under a matrix-heavy load).
CHIPS = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        "H100 SXM", bf16_tflops=989, tf32_tflops=495, fp32_tflops=67,
        hbm_gbps=3350),
}


def card_label() -> str:
    """Each card's name and power limit as ``nvidia-smi`` reports them
    (one card per line). A card set below its maximum power runs slower
    under load, so every recorded time carries this label."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def detect_chip(device_kind: str | None = None) -> ChipSpec:
    """Peak table row for ``device_kind`` (default: the first device's).
    A device that is not in the table is an error: no peak is assumed."""
    kind = device_kind or jax.devices()[0].device_kind
    try:
        return CHIPS[kind]
    except KeyError:
        raise ValueError(
            f"no peak table entry for device kind {kind!r}; known: "
            f"{sorted(CHIPS)}") from None


@dataclasses.dataclass
class Roofline:
    """Measured-vs-peak summary for one op."""
    seconds: float
    flops: float
    bytes: float
    chip: ChipSpec | None

    @property
    def tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    def fraction_of_peak(self, precision: str = "highest") -> float | None:
        """max(compute, memory) fraction of the roofline bound; None
        without a chip."""
        if self.chip is None:
            return None
        return max(self.tflops / self.chip.peak_tflops(precision),
                   self.gbps / self.chip.hbm_gbps)

    def __str__(self):
        s = f"{self.seconds*1e3:.3f} ms, {self.tflops:.2f} TFLOP/s, " \
            f"{self.gbps:.0f} GB/s"
        frac = self.fraction_of_peak()
        if frac is not None:
            s += f", {100*frac:.0f}% of roofline ({self.chip.name})"
        return s


def measure(fn, *args, flops: float = 0, bytes: float = 0,
            reps: int = 10, chip: ChipSpec | None = None) -> Roofline:
    """Time a jitted callable; with ``chip`` (``detect_chip()`` on the
    card) the result also reports roofline occupancy.

    ``flops``/``bytes`` are the caller's op accounting (e.g. 4·b·m·n and
    m·n·itemsize for a correlation product).
    """
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return Roofline(seconds=(time.perf_counter() - t0) / reps, flops=flops,
                    bytes=bytes, chip=chip)
