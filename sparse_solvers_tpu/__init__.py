"""sparse-solvers-tpu — batched ℓ₁-minimization and greedy sparse recovery.

A JAX/XLA library, run on NVIDIA GPUs, with the capabilities of the reference
C++ library rayglover-ibm/sparse-solvers: Homotopy (path-following with an
incrementally maintained active-set Gram inverse) and IRLS (iteratively
reweighted least squares over a cached QR) solvers for
``min ‖x‖₁ s.t. Ax = y``, batched with vmap and scalable across device meshes
by row-sharding the sensing matrix.

Public surface mirrors the reference Python package ``sparsesolvers``
(reference: bindings/python/sparsesolvers/binding.cpp:114-148).
"""

from .api import (Cosamp, Homotopy, Irls, IrlsCg, Omp,
                  densify_batch, densify_path,
                  lasso_at, lasso_at_batch,
                  reconstruct_signal, norm_l1)
from .reports import HomotopyReport, IrlsReport, OmpReport
from .utils.config import version

__all__ = [
    "Cosamp",
    "Homotopy",
    "Irls",
    "IrlsCg",
    "Omp",
    "HomotopyReport",
    "IrlsReport",
    "OmpReport",
    "densify_batch",
    "densify_path",
    "lasso_at",
    "lasso_at_batch",
    "reconstruct_signal",
    "norm_l1",
    "version",
]
