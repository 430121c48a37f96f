"""Dense primitives (the accelerator analog of the BLAS layer) and the
slot-space batch primitives of the throughput drivers."""
from . import blas, slot  # noqa: F401
