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


_ADD = kbuild.bind("probe", "fd_probe_add", 3, (kbuild.I64,), counter="probe_add")
_CONV = kbuild.bind("probe", "fd_probe_conv", 3, (kbuild.I64,), counter="probe_conv")


def _check(name, x, y, rows=None):
    """-> the inputs' device: two contiguous int32 tensors of one shape."""
    dev = x.device
    if x.dtype != torch.int32 or y.dtype != torch.int32 or x.shape != y.shape \
            or y.device != dev or not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name}: two contiguous int32 tensors of one shape on"
                         " one device")
    if rows is not None and (x.dim() != 2 or x.shape[0] != rows):
        raise ValueError(f"{name}: inputs must be ({rows}, B)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def probe_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise int32 x + y; replaces scripts/probe_pallas.py:18
    add_kernel.  CPU tensors run the plain version."""
    dev = _check("probe_add", x, y)
    if dev.type == "cpu":
        return probe_add_plain(x, y)
    out = torch.empty_like(x)
    n = out.numel()
    if n:
        _ADD(dev, x.data_ptr(), y.data_ptr(), out.data_ptr(), n)
    return out


def probe_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(20, B) int32 x2 -> (39, B) unreduced limb convolution, wrapping
    mod 2^32; replaces scripts/probe_pallas.py:34 conv_kernel.  The kernel
    (csrc/probe.cu) splits the 39 output rows over four warps by product
    count, each thread one lane's rows of its warp, 32 lanes a block,
    while one lane a thread would leave an SM idle (B <= 128 x SMs);
    past that, one lane a thread computes all 39 rows.  CPU tensors run
    the plain version."""
    dev = _check("probe_conv", a, b, rows=NLIMB)
    if dev.type == "cpu":
        return probe_conv_plain(a, b)
    out = torch.empty((2 * NLIMB - 1, a.shape[1]), dtype=torch.int32, device=dev)
    if a.shape[1]:
        _CONV(dev, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1])
    return out
