"""Build and load the CUDA kernels in csrc/ (the counterpart of
firedancer_tpu/utils/nativebuild.py).

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface, `build/torch_kernels/<hash>/lib<name>.so`, where
<hash> covers every source and header in csrc/ and the nvcc flags.  The
libraries are loaded with ctypes; wrappers pass raw device pointers and
PyTorch's current stream as `c_void_p`.  A plain C `.so` builds in seconds,
where an extension that includes PyTorch's headers takes minutes.

All missing libraries are built at once, one nvcc process per source,
started together.  The first build of each prints nvcc's `-Xptxas -v`
report (registers, spills) to stderr.  A build failure raises; nothing
degrades to a plain version.

Launch counts: every kernel wrapper adds one to `LAUNCHES[name]` where it
launches its kernel, and nowhere else.
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
    """Forget the loaded library of csrc/<name>.cu; the next load() opens
    the built file again (nothing is rebuilt)."""
    with _LOCK:
        _LIBS.pop(name, None)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        msg = lib.fd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, symbol: str, ptrs: list, bsz: int, device, counter: str) -> None:
    """Call csrc/<name>.cu's entry point `symbol`, whose arguments are the
    device pointers `ptrs` (None for a null pointer), B, the device index
    and the stream; raise on its error, else add one to LAUNCHES[counter]."""
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(*ptrs, bsz, device.index or 0, stream_ptr(device))
    check(lib, rc, f"{counter} launch")
    LAUNCHES[counter] += 1
