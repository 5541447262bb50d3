"""LtHash: the lattice-based incremental accounts hash, with the signed
row sum as a kernel (K13, csrc/lthash_combine.cu).

The port's counterpart of firedancer_tpu/ops/lthash.py: a hash value is
2,048 bytes viewed as 1,024 u16 lanes; hashing an input is BLAKE3 with
2,048 bytes of extended output (on the host, as in the JAX package: each
account's XOF is 32 sequential root compressions); combining is lanewise
u16 add, removal is subtract, so the accounts-delta hash is one signed sum
over every changed account, in any order.

`combine_device` is that sum over (N, 1024) rows in one launch of K13 on
the card, which writes the result itself: the sum across its blocks goes
through a per-stream accumulator (zeroed once here and left zero by every
launch), so no fill or mask pass runs beside it.  The rows travel as int16 tensors holding the u16 bit patterns
(torch's uint16 supports few operations) and the signs as int8; the
result is a (1024,) int32 tensor in [0, 65535], the JAX function's uint16
values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kbuild
from ..utils.platform import resolve_device
from . import blake3 as b3

# fd_lthash_combine(values, signs, scratch, out, n, chunks, ...)
_COMBINE = kbuild.bind("lthash_combine", "fd_lthash_combine", 4, (kbuild.I64, kbuild.I64))

LEN_BYTES = 2048
LEN_ELEMS = 1024
# K13's row chunks, one 256-thread block each: up to four blocks an SM of
# an H100 (132 SMs), and never fewer than 8 rows a chunk (one iteration of
# the block's loads; the kernel rounds a chunk up to a multiple of 8)
_MAX_CHUNKS = 528
_MIN_ROWS_PER_CHUNK = 8
# K13's scratch: 512 u64 lane-pair sums, each with its count of clusters
_SCRATCH_WORDS = LEN_ELEMS // 2
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def lthash_of(msg: bytes) -> np.ndarray:
    """(1024,) uint16 lattice hash of one input."""
    return np.frombuffer(b3.blake3_xof_host(msg, LEN_BYTES), dtype="<u2").copy()


def lthash_zero() -> np.ndarray:
    return np.zeros(LEN_ELEMS, dtype=np.uint16)


def lthash_add(r: np.ndarray, a: np.ndarray) -> np.ndarray:
    return (r + a).astype(np.uint16)


def lthash_sub(r: np.ndarray, a: np.ndarray) -> np.ndarray:
    return (r - a).astype(np.uint16)


def _rows(values, device) -> torch.Tensor:
    """(N, 1024) u16 values -> contiguous int16 bit patterns on the device
    (a tensor stays on its own device)."""
    if isinstance(values, torch.Tensor):
        if values.dtype not in (torch.int16, torch.uint16):
            raise ValueError(f"lthash rows must be 16-bit, got {values.dtype}")
        return values.view(torch.int16).contiguous()
    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint16)).view(np.int16)
    return torch.from_numpy(a).to(resolve_device(device))


def _signs(signs, n: int, dev: torch.device) -> torch.Tensor | None:
    if signs is None:
        return None
    if isinstance(signs, torch.Tensor):
        s = signs.to(device=dev, dtype=torch.int8).contiguous()
    else:
        s = torch.from_numpy(np.asarray(signs, dtype=np.int8).copy()).to(dev)
    if s.shape != (n,):
        raise ValueError(f"lthash signs must be ({n},), got {tuple(s.shape)}")
    return s


def chunks_of(n: int) -> int:
    """The row chunks (blocks) K13 is asked for at N rows."""
    return max(1, min(_MAX_CHUNKS, n // _MIN_ROWS_PER_CHUNK))


def _scratch(dev: torch.device) -> torch.Tensor:
    """K13's accumulator for dev's current stream: 512 u64 words, zeroed
    once here; each launch leaves them zero, so every caller on the stream
    may share them.  One per stream, so launches on two streams at once do
    not."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    s = _SCRATCH.get(key)
    if s is None:
        s = _SCRATCH[key] = torch.zeros((_SCRATCH_WORDS,), dtype=torch.int64, device=dev)
    return s


def combine_plain(v: torch.Tensor, s: torch.Tensor | None) -> torch.Tensor:
    """The plain version: (N, 1024) int16 bit patterns, (N,) int8 signs or
    None -> (1024,) int32 in [0, 65535]."""
    w = v.to(torch.int64) & 0xFFFF
    if s is not None:
        w = w * s.to(torch.int64)[:, None]
    return (w.sum(0) & 0xFFFF).to(torch.int32)


def combine_device(values, signs=None, *, device=None) -> torch.Tensor:
    """K13: sum (N, 1024) u16 lattice values, optionally signed -1/0/+1 per
    row, mod 2^16 -> (1024,) int32 tensor in [0, 65535] on the rows' device.

    Replaces ops/lthash.py:43 combine_device.  values: a numpy array (sent
    to `device`, default the card) or an int16/uint16 tensor (stays where it
    is).  On CPU tensors this runs the plain version; on CUDA tensors it
    launches csrc/lthash_combine.cu or raises.
    """
    v = _rows(values, device)
    if v.dim() != 2 or v.shape[1] != LEN_ELEMS:
        raise ValueError(f"lthash rows must be (N, {LEN_ELEMS}), got {tuple(v.shape)}")
    n = v.shape[0]
    s = _signs(signs, n, v.device)
    if v.device.type == "cpu":
        return combine_plain(v, s)
    if v.device.type != "cuda":
        raise ValueError(f"lthash combine: unsupported device {v.device}")
    if n == 0:
        return torch.zeros((LEN_ELEMS,), dtype=torch.int32, device=v.device)
    if v.data_ptr() % 16:  # the kernel reads 16-byte vectors
        v = v.clone()
    out = torch.empty((LEN_ELEMS,), dtype=torch.int32, device=v.device)
    _COMBINE(v.device, v.data_ptr(), s.data_ptr() if s is not None else None,
             _scratch(v.device).data_ptr(), out.data_ptr(), n, chunks_of(n))
    return out
