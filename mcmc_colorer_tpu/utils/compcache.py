"""Persistent XLA compilation cache.

JAX stores compiled executables keyed by HLO and flags, so a second
process that runs the same programs skips their compilation.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets nothing.  Otherwise the cache lives at one fixed path inside the
checkout, ``.jax_cache/`` (git-ignored): a cache directory that moves
between runs never hits.

The CLI, ``bench.py`` and ``chip_smoke.py`` call ``enable()`` before
their first compile.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)


def enable() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
