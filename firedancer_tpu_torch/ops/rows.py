"""The message-batch convention of the hash wrappers (K14, K16, K17): B
messages as a (max_len, B) uint8 tensor of byte rows, the batch trailing,
and their lengths as a (B,) int32 tensor on the same device.

The JAX ops give an unspecified digest for a length outside [0, max_len];
the port's wrappers raise ValueError instead, on both devices.  On a CUDA
tensor that check reads the lengths' minimum and maximum back to the host
(one synchronisation per call).
"""

from __future__ import annotations

import torch


def check_msg_batch(name: str, msg: torch.Tensor, msg_len: torch.Tensor,
                    max_len: int | None, limit: int | None = None) -> int:
    """Validate a message batch; returns max_len (default msg.shape[0])."""
    if msg.device != msg_len.device or msg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: msg on {msg.device}, msg_len on {msg_len.device}")
    if msg.dtype != torch.uint8 or msg.dim() != 2 or not msg.is_contiguous():
        raise ValueError(f"{name}: msg must be a contiguous (max_len, B) uint8 tensor,"
                         f" got {tuple(msg.shape)} {msg.dtype}")
    if msg_len.dtype != torch.int32 or tuple(msg_len.shape) != (msg.shape[1],) \
            or not msg_len.is_contiguous():
        raise ValueError(f"{name}: msg_len must be a contiguous ({msg.shape[1]},) int32"
                         f" tensor, got {tuple(msg_len.shape)} {msg_len.dtype}")
    if max_len is None:
        max_len = msg.shape[0]
    if not 0 <= max_len <= msg.shape[0]:
        raise ValueError(f"{name}: max_len {max_len} outside [0, {msg.shape[0]}]")
    if limit is not None and max_len > limit:
        raise ValueError(f"{name}: max_len {max_len} > {limit}")
    if msg_len.numel():
        lo, hi = torch.aminmax(msg_len)
        if int(lo) < 0 or int(hi) > max_len:
            raise ValueError(f"{name}: lengths in [{int(lo)}, {int(hi)}] outside"
                             f" [0, {max_len}]")
    return max_len


def check_rows(name: str, x: torch.Tensor, nrows: int, bsz: int | None = None) -> None:
    """x must be a contiguous (nrows, B) uint8 tensor (B = bsz when given)."""
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[0] != nrows \
            or not x.is_contiguous() or (bsz is not None and x.shape[1] != bsz):
        raise ValueError(f"{name}: expected a contiguous ({nrows}, B) uint8 tensor,"
                         f" got {tuple(x.shape)} {x.dtype}")
