"""Build and load the CUDA kernels in csrc/ (the counterpart of
firedancer_tpu/utils/nativebuild.py).

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface, `build/torch_kernels/<hash>/lib<name>.so`, where
<hash> covers every source and header in csrc/ and the nvcc flags.  The
libraries are loaded with ctypes and every entry point is reached through
`bind`: a bound entry point is a cached callable that sets its ctypes
argument types once, and per call passes the device pointers, the sizes,
the device index and the caller's current stream (its raw handle), checks
the return code and counts the launch.  Only the first call of an entry
point takes the lock (to build and load its library).  A plain C `.so`
builds in seconds, where an extension that includes PyTorch's headers
takes minutes.

All missing libraries are built at once, one nvcc process per source,
started together.  The first build of each prints nvcc's `-Xptxas -v`
report (registers, spills) to stderr.  A build failure raises; nothing
degrades to a plain version.

Launch counts: a bound entry point adds one to `LAUNCHES[counter]` after
each launch its C function reports as started, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
]

LAUNCHES: Counter = Counter()

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


class KernelBuildError(RuntimeError):
    pass


def reset_launches() -> None:
    LAUNCHES.clear()


def kernel_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC_DIR)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC_DIR, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, _source_hash())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Build every missing library in parallel; {name: .so path}."""
    names = names or kernel_names()
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths = {n: os.path.join(out_dir, f"lib{n}.so") for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        sys.stderr.write(f"[kbuild] nvcc {n}.cu rc={p.returncode}"
                         f" ({BUILD_SECONDS[n]:.1f}s)\n{log}")
        if p.returncode != 0:
            failed.append(n)
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            os.replace(tmp, paths[n])
    sys.stderr.flush()
    if failed:
        raise KernelBuildError(f"nvcc failed for {', '.join(failed)}")
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            lib.fd_cuda_error_string.argtypes = [ctypes.c_int]
            lib.fd_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def is_loaded(name: str) -> bool:
    """Whether csrc/<name>.cu's library is loaded in this process."""
    return name in _LIBS


def unload(name: str) -> None:
    """Forget the loaded library of csrc/<name>.cu and unbind its entry
    points; the next launch opens the built file again (nothing is
    rebuilt)."""
    with _LOCK:
        _LIBS.pop(name, None)
        for k in _BOUND.values():
            if k.name == name:
                k.unbind()


# The caller's current stream on a device index, as a raw cudaStream_t:
# torch._C._cuda_getCurrentRawStream, looked up at the first launch (the
# CPU build of PyTorch has no such function).  It follows
# `torch.cuda.stream(...)` as `torch.cuda.current_stream(i).cuda_stream`
# does, without building a Stream object per call.
current_raw_stream = None

PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64  # argument types for bind


class Kernel:
    """One C entry point of csrc/<name>.cu, `int symbol(argtypes...,
    int device, void* stream)` returning a cudaError_t.  Call it as
    `kernel(device, *args)`: args are the ints and pointers (Python ints
    from data_ptr(), None for a null pointer) in the order of argtypes."""

    __slots__ = ("name", "symbol", "counter", "argtypes", "_fn", "_lib")

    def __init__(self, name: str, symbol: str, argtypes: list, counter: str):
        self.name, self.symbol, self.counter = name, symbol, counter
        self.argtypes = argtypes + [ctypes.c_int, ctypes.c_void_p]
        self._fn = self._lib = None

    def unbind(self) -> None:
        self._fn = self._lib = None

    def _bind(self):
        global current_raw_stream
        with _BIND_LOCK:
            if self._fn is None:
                lib = load(self.name)
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                if current_raw_stream is None:
                    import torch

                    current_raw_stream = torch._C._cuda_getCurrentRawStream
                self._lib, self._fn = lib, fn
            return self._fn

    def __call__(self, device, *args) -> None:
        fn = self._fn or self._bind()
        index = device.index or 0
        rc = fn(*args, index, current_raw_stream(index))
        if rc:
            msg = (self._lib or load(self.name)).fd_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.counter} launch: CUDA error {rc} ({msg})")
        LAUNCHES[self.counter] += 1


_BOUND: dict[tuple[str, str], Kernel] = {}
_BIND_LOCK = threading.Lock()


def bind(name: str, symbol: str, n_ptrs: int, extra_argtypes=(), counter: str | None = None) -> Kernel:
    """The bound entry point `symbol` of csrc/<name>.cu, whose arguments are
    n_ptrs device pointers, then `extra_argtypes` (ctypes types), then the
    device index and the stream; launches count under `counter` (default
    `name`).  One Kernel per (name, symbol): binding again returns it.
    Nothing is built or loaded until its first call."""
    key = (name, symbol)
    k = _BOUND.get(key)
    if k is None:
        k = _BOUND.setdefault(key, Kernel(name, symbol, [PTR] * n_ptrs + list(extra_argtypes),
                                          counter or name))
    if k.counter != (counter or name):
        raise ValueError(f"{name}.{symbol} already bound with counter {k.counter!r}")
    return k
