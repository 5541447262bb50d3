"""Keccak-256 with the legacy 0x01 padding (the Solana syscall flavour):
the host reference (the port's copy of firedancer_tpu/ops/keccak256.py:23-90)
and the batched device path, K17 `keccak256_msg` (csrc/keccak256_msg.cu).

Rate 136, capacity 512, padding 0x01 ... 0x80, NOT the SHA-3 0x06 variant:
this is what sol_keccak256 and secp256k1_recover consume, so hashlib's
sha3_256 is no oracle and `keccak256_host` is.  `_keccak_f_host` is the
permutation that merlin transcripts and the secp256k1 precompile use.

`keccak256_msg` hashes B messages as (max_len, B) uint8 rows with (B,) int32
lengths (ops/rows.py) -> (32, B) uint8.  The plain version absorbs every
block for every lane and keeps each lane's state after its own final block
(len // 136), as the JAX op does; it holds each 64-bit lane as two 32-bit
halves in int64 tensors (torch's `>>` on int64 is arithmetic), like
ops/sha512.py.  The kernel keeps native uint64 lanes and runs only each
lane's own blocks.
"""

from __future__ import annotations

import torch

from ..utils import kbuild
from .rows import check_msg_batch

_KECCAK = kbuild.bind("keccak256_msg", "fd_keccak256_msg", 3, (kbuild.I64,))

RATE = 136
OUT_SZ = 32

# round constants (Keccak spec, LFSR-generated protocol constants)
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets, lane index x + 5y (x fastest), as the theta/pi formulas
# below index them
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]
_M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF


def _rotl64(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _M64 if n else v


def _keccak_f_host(a: list[int]) -> list[int]:
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    a[x + 5 * y], _ROT[x + 5 * y]
                )
        # chi
        a = [
            b[i] ^ ((~b[(i + 1) % 5 + 5 * (i // 5)]) & b[(i + 2) % 5 + 5 * (i // 5)] & _M64)
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


def keccak256_host(msg: bytes) -> bytes:
    a = [0] * 25
    padded = bytearray(msg)
    padded.append(0x01)
    while len(padded) % RATE:
        padded.append(0)
    padded[-1] ^= 0x80
    for off in range(0, len(padded), RATE):
        block = padded[off : off + RATE]
        for i in range(RATE // 8):
            a[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        a = _keccak_f_host(a)
    return b"".join(a[i].to_bytes(8, "little") for i in range(4))


# -- batched device path (K17) -------------------------------------------------


def _rotl_pair(lo, hi, n: int):
    """Rotate the u64 (hi:lo) left by n; halves below 2^32 in int64."""
    if n == 0:
        return lo, hi
    if n == 32:
        return hi, lo
    if n > 32:
        lo, hi, n = hi, lo, n - 32
    return (((lo << n) | (hi >> (32 - n))) & M32,
            ((hi << n) | (lo >> (32 - n))) & M32)


def _keccak_f_plain(lo: list, hi: list):
    """One permutation over 25 (lo, hi) lanes of (B,) int64 tensors."""
    for rc in _RC:
        c_lo = [lo[x] ^ lo[x + 5] ^ lo[x + 10] ^ lo[x + 15] ^ lo[x + 20] for x in range(5)]
        c_hi = [hi[x] ^ hi[x + 5] ^ hi[x + 10] ^ hi[x + 15] ^ hi[x + 20] for x in range(5)]
        d = []
        for x in range(5):
            rl, rh = _rotl_pair(c_lo[(x + 1) % 5], c_hi[(x + 1) % 5], 1)
            d.append((c_lo[(x - 1) % 5] ^ rl, c_hi[(x - 1) % 5] ^ rh))
        lo = [lo[i] ^ d[i % 5][0] for i in range(25)]
        hi = [hi[i] ^ d[i % 5][1] for i in range(25)]
        b_lo, b_hi = [None] * 25, [None] * 25
        for x in range(5):
            for y in range(5):
                j = y + 5 * ((2 * x + 3 * y) % 5)
                b_lo[j], b_hi[j] = _rotl_pair(lo[x + 5 * y], hi[x + 5 * y], _ROT[x + 5 * y])
        lo = [b_lo[i] ^ (~b_lo[(i + 1) % 5 + 5 * (i // 5)] & M32 & b_lo[(i + 2) % 5 + 5 * (i // 5)])
              for i in range(25)]
        hi = [b_hi[i] ^ (~b_hi[(i + 1) % 5 + 5 * (i // 5)] & M32 & b_hi[(i + 2) % 5 + 5 * (i // 5)])
              for i in range(25)]
        lo[0] = lo[0] ^ (rc & M32)
        hi[0] = hi[0] ^ (rc >> 32)
    return lo, hi


def keccak256_msg_plain(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int) -> torch.Tensor:
    """K17's plain version: (max_len, B) uint8 + (B,) lengths -> (32, B)
    uint8, every block absorbed for every lane."""
    bsz, dev = msg.shape[1], msg.device
    nb = (max_len + 1 + RATE - 1) // RATE  # + 1: the 0x01 pad byte
    total = nb * RATE
    ln = msg_len.to(torch.int64)
    buf = torch.zeros((total, bsz), dtype=torch.int64, device=dev)
    buf[:max_len] = msg[:max_len].to(torch.int64)
    pos = torch.arange(total, dtype=torch.int64, device=dev).unsqueeze(1)
    buf = torch.where(pos < ln, buf, 0) + torch.where(pos == ln, 0x01, 0)
    final_block = ln // RATE  # the block holding the 0x01 byte
    buf = buf ^ torch.where(pos == final_block * RATE + RATE - 1, 0x80, 0)
    by = buf.reshape(nb, RATE // 8, 8, bsz)
    w_lo = by[:, :, 0] | (by[:, :, 1] << 8) | (by[:, :, 2] << 16) | (by[:, :, 3] << 24)
    w_hi = by[:, :, 4] | (by[:, :, 5] << 8) | (by[:, :, 6] << 16) | (by[:, :, 7] << 24)
    zero = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    lo, hi = [zero] * 25, [zero] * 25
    res = torch.zeros((4, 2, bsz), dtype=torch.int64, device=dev)
    for bi in range(nb):
        for i in range(RATE // 8):
            lo[i] = lo[i] ^ w_lo[bi, i]
            hi[i] = hi[i] ^ w_hi[bi, i]
        lo, hi = _keccak_f_plain(lo, hi)
        state = torch.stack([torch.stack([lo[i], hi[i]]) for i in range(4)])
        res = torch.where(final_block == bi, state, res)
    sh = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=dev).reshape(1, 1, 4, 1)
    return ((res.unsqueeze(2) >> sh) & 0xFF).reshape(32, bsz).to(torch.uint8)


def _keccak256_msg_launch(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/keccak256_msg.cu on checked CUDA inputs."""
    bsz = msg.shape[1]
    out = torch.empty((OUT_SZ, bsz), dtype=torch.uint8, device=msg.device)
    _KECCAK(msg.device, msg.data_ptr(), msg_len.data_ptr(), out.data_ptr(), bsz)
    return out


def keccak256_msg(msg: torch.Tensor, msg_len: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
    """K17: batched Keccak-256, (max_len, B) uint8 + (B,) int32 lengths ->
    (32, B) uint8 digests.

    Replaces ops/keccak256.py:148 keccak256_msg.  max_len defaults to
    msg.shape[0]; a length outside [0, max_len] raises ValueError.  On CPU
    tensors this runs the plain version; on CUDA tensors it launches
    csrc/keccak256_msg.cu or raises.
    """
    max_len = check_msg_batch("keccak256_msg", msg, msg_len, max_len)
    if msg.device.type == "cpu":
        return keccak256_msg_plain(msg, msg_len, max_len)
    return _keccak256_msg_launch(msg, msg_len)
