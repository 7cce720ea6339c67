"""Persistent XLA compile cache at a fixed path.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
``enable`` sets nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``
(listed in .gitignore).  The path is fixed — never made from a temporary
name, a process id or the time — because it is part of the cache key: a
directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
