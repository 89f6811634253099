"""Build the port's CUDA sources at first use and load them through ctypes.

Each ``ddl_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/ddl_tpu_torch/`` in the checkout.  The file
name carries a hash of the source, its headers and the flags, so an edited
source is rebuilt and a stale library is never loaded.  ``build()``
starts one ``nvcc`` per source, all at once, and waits for every one.

Nothing here runs at import: the CPU tests import every module of the
port, and the toolkit is only needed when a kernel is first launched on a
CUDA tensor (or ``build()`` is called).  A failed build raises; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "H100_SMS", "NVCC_FLAGS", "SMEM_PER_BLOCK", "build", "check", "load",
           "sass", "sm_count"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddl_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The H100's SMs and the shared memory one block may use there (227 KB with
# the opt-in): what the kernels' launch plans are sized for.
H100_SMS = 132
SMEM_PER_BLOCK = 232448

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "the CUDA toolkit (nvcc) was not found; it is needed to build "
            "ddl_tpu_torch's kernels"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` each, all started together.  Each compiler's
    output (with ``-Xptxas -v``: registers, shared memory, spills) is kept
    in ``<name>.log`` beside the library.  Raises after every compiler has
    exited if any failed."""
    names = sorted(names or (p.stem for p in _CSRC.glob("*.cu")))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _lib_path(name) for name in names}


def sass(name: str) -> str:
    """The machine code of ``csrc/<name>.cu``'s library (built if needed),
    as ``cuobjdump -sass`` from the toolkit prints it."""
    lib = build([name])[name]
    return subprocess.run(
        [str(Path(_nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
        capture_output=True, text=True, check=True,
    ).stdout


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with ``argtypes``
    set from ``signatures`` (function name -> ctypes argument types) and
    every function returning an ``int`` CUDA error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.ddl_error_string.argtypes = [ctypes.c_int]
            lib.ddl_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = lib.ddl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
