"""Build and load the hand-written CUDA kernels under ``kernels/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled with ``nvcc`` at first use and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v [SOURCE_FLAGS[name]] -I csrc \
         -o _build/<name>-<hash>.so csrc/<name>.cu

The output goes to ``diffqcqp_tpu_torch/_build/`` (listed in .gitignore),
keyed by a hash of the flags, the source and every header in ``csrc``, so an
edited source rebuilds and an unchanged one is reused. ``-Xptxas=-v``'s
report (registers, shared memory, spills) is kept beside the library as
``<name>-<hash>.log``. Nothing here runs at import: importing the package,
or collecting its tests, needs no ``nvcc``.

``check_launch`` and ``check_rc`` are the checks every kernel wrapper makes
around a launch: inputs, shared memory and block size (against the
kernel's own ``__launch_bounds__``) before it, the kernel's
``cudaGetLastError()`` code after it. ``count_launch`` then adds one to the
wrapper's ``launches`` counter under one lock, since the shards of a sharded
solve (``parallel/sharding.py``) launch from several threads.

``BUILD_DIR`` is where the libraries go; ``utils/cache.py::
enable_compilation_cache`` points it elsewhere.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "NVCC_FLAGS", "SOURCES", "build", "load", "library_path", "check_geometry", "check_launch",
    "check_rc", "count_launch", "fits", "row_threads",
]

ROW_BOUND = 256     # __launch_bounds__ of the thread-per-row kernels (K1; K4 above n = 32)
HOPPER_SMEM_OPTIN = 232448   # dynamic shared memory a block may opt into on sm_90 (227 KB)

CSRC = Path(__file__).resolve().parent / "csrc"
# every csrc/<name>.cu, one library each
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# flags of one source on top of NVCC_FLAGS: K1 contracts no product and sum
# into a fused multiply-add (only its explicit fmaf / fma calls are fused),
# so that its plain version's torch ops round as it does (csrc/admm.cu)
SOURCE_FLAGS = {"admm": ("-fmad=false",)}

_lock = threading.Lock()
_count_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "are compiled from diffqcqp_tpu_torch/kernels/csrc at first use"
    )


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is built, keyed by content."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ())).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns seconds per name
    built (0.0 for one already there). Raises on a failed compile with the
    compiler's output."""
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    out = {n: 0.0 for n in names}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)      # atomic: a concurrent loader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.dq_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dq_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check_geometry(threads: int, smem: int, bound: int, limit: int) -> None:
    """Raise unless a block of ``threads`` fits the kernel's
    ``__launch_bounds__`` (``bound``) and its ``smem`` bytes of dynamic
    shared memory fit ``limit``, what the card lets a block opt into."""
    if threads > bound or smem > limit:
        raise ValueError(
            f"a block of {threads} threads and {smem} bytes of shared memory is past "
            f"what the kernel takes: at most {bound} threads (its __launch_bounds__) "
            f"and {limit} bytes on this card"
        )


def fits(threads: int, smem: int, bound: int) -> bool:
    """Whether a block of ``threads`` threads and ``smem`` bytes of dynamic
    shared memory launches on a Hopper card under a ``__launch_bounds__`` of
    ``bound``: the device-independent form of ``check_geometry`` that the
    dispatch rules use, decided from shapes alone before anything launches."""
    return threads <= bound and smem <= HOPPER_SMEM_OPTIN


def check_launch(tensors, threads: int, smem: int, bound: int) -> torch.device:
    """Raise unless every tensor is a contiguous float32 on one CUDA device
    and the launch passes ``check_geometry`` on that device. Returns the
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"all inputs must lie on one CUDA device, got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
    check_geometry(threads, smem, bound,
                   torch.cuda.get_device_properties(dev).shared_memory_per_block_optin)
    return dev


def row_threads(n: int) -> int:
    """Threads of a thread-per-row block at size n: whole warps."""
    return 32 * ((n + 31) // 32)


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {lib.dq_cuda_error_string(rc).decode()}"
        )


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a kernel wrapper's launch counter),
    under a lock: a bare ``+= 1`` from two threads can lose one."""
    with _count_lock:
        wrapper.launches += 1
