"""Library configuration and version.

Analog of the reference's generated config header
(reference: include/ss/ss_config.h.in:8-19) — carries the library name and
semantic version, and where scripts keep JAX's persistent compile cache.
"""

from __future__ import annotations

import os

LIB_NAME = "sparse-solvers-tpu"

VERSION_MAJOR = 0
VERSION_MINOR = 2
VERSION_PATCH = 0

# the checkout root: this file is <checkout>/sparse_solvers_tpu/utils/
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def version() -> list[int]:
    """Return ``[major, minor, patch]``.

    Mirrors the reference Python binding's ``version()``
    (reference: bindings/python/sparsesolvers/binding.cpp:42-45,117).
    """
    return [VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH]


def use_compile_cache() -> str:
    """Give a script JAX's persistent compilation cache; returns its
    directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set in code. Otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache``: the directory is part of every entry's
    key, so a path that moved between runs would never hit.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
