"""Linear-algebra components (device analogs of reference src/linalg)."""
from . import active_set, cholesky, norms, online_inverse, qr  # noqa: F401
