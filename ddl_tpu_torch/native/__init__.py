"""ctypes binding of the port's native image decoder (``loader.cpp``; the
JAX package's native loader binding has the same functions, and the port
never loads or builds that package's library).

The library is built at first use, never at import: ``g++ -O3 -fPIC
-shared -std=c++17`` into ``build/ddl_tpu_torch/libddl_loader-<hash>.so``
in the checkout, the hash covering the source, the flags and the
compiler's version.  PNG decodes on top of zlib, which the build links;
a probe (a tiny program compiled and linked against libjpeg) adds JPEG
where libjpeg is there (else ``.jpg`` files fail to decode).

Callers handle ``loader_lib() is None``: without a compiler the data
loader falls back to PIL, per sample.  That fallback is never silent: a
failed build keeps the compiler's output in ``libddl_loader.log`` beside
the library and warns once with it, and ``batches`` counts the batches
the loader decoded natively (``"native"``) and those of a file-backed
dataset that went through PIL (``"pil"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

__all__ = ["batches", "build", "count_batch", "image_size", "load_batch", "loader_lib",
           "native_available", "open_library", "probe"]

_SRC = Path(__file__).with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddl_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# one tiny program per optional library: it compiles and links, or the
# build goes without that library
_PROBES = {
    "libjpeg": ("#include <cstdio>\n#include <jpeglib.h>\n"
                "int main() { jpeg_error_mgr e; return jpeg_std_error(&e) == nullptr; }\n",
                ("-ljpeg",)),
}

# batches the data loader decoded natively, and those of a file-backed
# dataset that went through PIL instead (count_batch; loaders count from
# their producer threads)
batches = {"native": 0, "pil": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
_tried = False


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _compiler_id() -> str:
    """The compiler's version line (part of the library's hash: a library
    another compiler built is never loaded), or "" if it does not run."""
    try:
        out = subprocess.run([_cxx(), "--version"], capture_output=True, text=True, timeout=60)
        return out.stdout.splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def probe() -> dict[str, bool]:
    """Which optional libraries a program can include and link here."""
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (code, libs) in _PROBES.items():
            src = Path(tmp) / f"{name}.cpp"
            src.write_text(code)
            try:
                proc = subprocess.run([_cxx(), str(src), "-o", str(Path(tmp) / name), *libs],
                                      capture_output=True, timeout=120)
                found[name] = proc.returncode == 0
            except (OSError, subprocess.SubprocessError):
                found[name] = False
    return found


def build(libjpeg: bool | None = None) -> Path:
    """Compile ``loader.cpp`` (with libjpeg where the probe finds it,
    unless ``libjpeg`` is given) unless it is built already; returns the
    library's path.  Raises ``RuntimeError`` with the compiler's output
    if the build fails (the output is also kept in ``libddl_loader.log``)."""
    if libjpeg is None:
        libjpeg = probe()["libjpeg"]
    defines = (f"-DDDL_LIBJPEG={int(libjpeg)}",)
    libs = (*(("-ljpeg",) if libjpeg else ()), "-lz", "-lpthread")
    h = hashlib.sha1(" ".join((*CXX_FLAGS, *defines, *libs, _compiler_id())).encode())
    h.update(_SRC.read_bytes())
    out = BUILD_DIR / f"libddl_loader-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, *defines, "-o", str(tmp), str(_SRC), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        log, rc = proc.stdout + proc.stderr, proc.returncode
    except (OSError, subprocess.SubprocessError) as e:
        log, rc = f"{type(e).__name__}: {e}", 1
    (BUILD_DIR / "libddl_loader.log").write_text(f"{' '.join(cmd)}\n{log}")
    if rc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_SRC.name} failed:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return out


def open_library(path: str | os.PathLike) -> ctypes.CDLL:
    """Load a built library and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    lib.ddl_pool_init.argtypes = [ctypes.c_int]
    lib.ddl_load_batch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_uint8)]
    lib.ddl_load_batch.restype = ctypes.c_int
    lib.ddl_image_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.ddl_pool_init(max(2, (os.cpu_count() or 4) // 2))
    return lib


def loader_lib():
    """The loaded library (built at the first call), or None if it cannot
    be built or loaded; the first failure warns with the reason."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = open_library(build())
        except (RuntimeError, OSError) as e:
            warnings.warn(f"native image decoder unavailable; the data loader falls back "
                          f"to PIL:\n{e}", RuntimeWarning, stacklevel=2)
        return _lib


def count_batch(route: str) -> None:
    """One more batch decoded by ``route`` (``"native"`` or ``"pil"``)."""
    with _count_lock:
        batches[route] += 1


def native_available() -> bool:
    return loader_lib() is not None


def image_size(path: str | os.PathLike, lib=None) -> tuple[int, int] | None:
    """(height, width) of a PNG via the native probe, or None."""
    lib = lib or loader_lib()
    if lib is None:
        return None
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.ddl_image_size(str(path).encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def load_batch(paths: list[str | os.PathLike], height: int, width: int,
               lib=None) -> np.ndarray | None:
    """Decode a batch of image files into one (N, H, W, 3) uint8 array on
    the native thread pool; None if the library is unavailable or any
    image failed to decode (the caller falls back to PIL).  ``lib``
    (default: the probed build) is a library from ``open_library``."""
    lib = lib or loader_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    joined = "\n".join(str(p) for p in paths).encode()
    ok = lib.ddl_load_batch(joined, n, height, width,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if ok == n else None
