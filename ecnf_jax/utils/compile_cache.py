"""Persistent XLA compilation cache.

The reference has no compile-time story (every process re-traces and
re-compiles).  The big jitted programs here take tens of seconds to
minutes to build, and JAX's in-memory cache dies with the process; the
persistent cache lets a restart (training resume, serving, benchmarks)
skip straight to execution when the program and compiler are unchanged.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` if it is set (and no
other directory is set in code), else a directory already configured in
``jax.config``, else the fixed ``<repo>/.jax_cache`` inside this checkout.
The path never depends on a temp name, process id or time, so a later
process finds what an earlier one cached.  ``ECNF_COMPILE_CACHE=0`` (or ``off``/``none``/
``false``) turns the cache off; the tests use it to stay hermetic.
"""
import os
from pathlib import Path
from typing import Optional

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_compilation_cache(
    min_compile_time_secs: float = 5.0,
) -> Optional[str]:
    """Route compiled executables through an on-disk cache.

    Returns the cache directory in use, or None when disabled by
    ``ECNF_COMPILE_CACHE``.
    """
    import jax

    opt_out = os.environ.get("ECNF_COMPILE_CACHE", "").strip().lower()
    if opt_out in ("0", "off", "none", "false"):
        return None
    path = (
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or jax.config.jax_compilation_cache_dir
        or str(REPO_CACHE_DIR)
    )
    jax.config.update("jax_compilation_cache_dir", path)
    # Only programs worth the disk round-trip; tiny programs recompile
    # faster than they deserialize.
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
