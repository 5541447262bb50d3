"""Build and load the host C++ libraries in native/ (the counterpart of
firedancer_tpu/utils/nativebuild.py, for the host side only).

Each `native/<name>.cpp` is compiled by `CXX` into
`build/torch_native/<hash>/lib<name>.so`, where <hash> covers that source,
the compiler and its flags, and loaded with ctypes.  The build goes to a
temporary file that is renamed into place, so processes that build the
same library at once never load a half-written one.  A compiler failure
raises `HostBuildError`: nothing falls back to another lane, and no
environment variable switches anything.

This is kept apart from utils/kbuild.py (the nvcc builds of csrc/), whose
hash covers every file in csrc/: a host source there would rebuild every
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_native")

CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class HostBuildError(RuntimeError):
    pass


def source(name: str) -> str:
    return os.path.join(NATIVE_DIR, f"{name}.cpp")


def so_path(name: str) -> str:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    with open(source(name), "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def build(name: str) -> str:
    """Compile native/<name>.cpp if its library is missing; its path."""
    path = so_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        p = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, source(name)],
                           capture_output=True, text=True)
    except OSError as e:
        raise HostBuildError(f"{CXX} could not run for {name}.cpp: {e}") from e
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise HostBuildError(f"{CXX} failed for {name}.cpp (rc {p.returncode}):\n{p.stderr}")
    os.replace(tmp, path)
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of native/<name>.cpp, built on first use."""
    path = so_path(name)
    with _LOCK:
        lib = _LIBS.get(path)
        if lib is None:
            lib = _LIBS[path] = ctypes.CDLL(build(name))
    return lib
