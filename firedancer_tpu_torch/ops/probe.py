"""The toolchain probes (the counterparts of scripts/probe_pallas.py):
`probe_add` and `probe_conv` launch the two kernels of csrc/probe.cu, with
their plain versions beside them.  They prove that a hand-written kernel
builds, launches and returns the right integers on the card; nothing on the
leader's path calls them.
"""

from __future__ import annotations

import torch

from ..utils import kbuild

NLIMB = 20


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with int32 wraparound."""
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def probe_add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _wrap32(x.to(torch.int64) + y.to(torch.int64))


def probe_conv_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[k] = sum_{i + j = k} a[i] * b[j] over (20, B) limb rows."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    rows = []
    for k in range(2 * NLIMB - 1):
        lo, hi = max(0, k - NLIMB + 1), min(k, NLIMB - 1)
        rows.append(sum(a[i] * b[k - i] for i in range(lo, hi + 1)))
    return _wrap32(torch.stack(rows))


def _launch(fn_name: str, name: str, ins, out, n: int):
    import ctypes

    if n == 0:
        return out
    lib = kbuild.load("probe")
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = out.device
    rc = fn(ins[0].data_ptr(), ins[1].data_ptr(), out.data_ptr(), n,
            dev.index or 0, kbuild.stream_ptr(dev))
    kbuild.check(lib, rc, f"{name} launch")
    kbuild.LAUNCHES[name] += 1
    return out


def _check(name, x, y, rows=None):
    if x.device != y.device or x.shape != y.shape or x.dtype != torch.int32 \
            or y.dtype != torch.int32 or not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name}: two contiguous int32 tensors of one shape on"
                         " one device")
    if rows is not None and (x.dim() != 2 or x.shape[0] != rows):
        raise ValueError(f"{name}: inputs must be ({rows}, B)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def probe_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise int32 x + y; replaces scripts/probe_pallas.py:18
    add_kernel.  CPU tensors run the plain version."""
    _check("probe_add", x, y)
    if x.device.type == "cpu":
        return probe_add_plain(x, y)
    return _launch("fd_probe_add", "probe_add", (x, y), torch.empty_like(x), x.numel())


def probe_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(20, B) int32 x2 -> (39, B) unreduced limb convolution; replaces
    scripts/probe_pallas.py:34 conv_kernel.  CPU tensors run the plain
    version."""
    _check("probe_conv", a, b, rows=NLIMB)
    if a.device.type == "cpu":
        return probe_conv_plain(a, b)
    out = torch.empty((2 * NLIMB - 1, a.shape[1]), dtype=torch.int32, device=a.device)
    return _launch("fd_probe_conv", "probe_conv", (a, b), out, a.shape[1])
