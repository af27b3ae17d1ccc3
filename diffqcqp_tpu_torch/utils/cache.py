"""Where the CUDA libraries are built (port of utils/cache.py).

The JAX package's ``enable_compilation_cache`` turns on JAX's persistent
compilation cache, so a fleet pays each compile once. The port's kernels
are shared libraries that ``kernels/_build.py`` compiles with ``nvcc`` at
first use and names by a hash of their flags and sources, so a library
built once is loaded by every later process that finds it. This call
points that build directory (by default ``diffqcqp_tpu_torch/_build`` in
the package) at a directory the caller chooses:

    import diffqcqp_tpu_torch as dqt
    dqt.enable_compilation_cache("/var/cache/diffqcqp_tpu_torch")  # once, at start

It applies to libraries loaded after the call; one a process has loaded
already stays as it is.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..kernels import _build

__all__ = ["enable_compilation_cache"]


def enable_compilation_cache(
    path: str = "~/.cache/diffqcqp_tpu_torch",
    min_compile_time_secs: float = 1.0,
) -> str:
    """Build and load the CUDA libraries under ``path`` (created if missing).
    Returns the resolved path. Safe to call more than once; the last call
    wins. ``min_compile_time_secs`` is accepted for the JAX signature and
    ignored: every library takes seconds of ``nvcc`` to build, so every one
    is worth keeping."""
    del min_compile_time_secs
    resolved = os.path.abspath(os.path.expanduser(path))
    os.makedirs(resolved, exist_ok=True)
    _build.BUILD_DIR = Path(resolved)
    return resolved
