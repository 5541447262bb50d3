"""ChaCha20: the host block function and the Solana protocol RNG (the port's
copy of firedancer_tpu/ops/chacha20.py:25-160), and the batched device
keystream, K18 `chacha20_keystream` (csrc/chacha20_keystream.cu).

The round structure and constants are RFC 7539/8439 (protocol constants);
the RNG semantics are pinned to rand_chacha::ChaCha20Rng::from_seed (key =
seed, nonce 0, counter 0, 64-byte blocks consumed as little-endian u64s)
with the two rejection-sampling "roll" modes Solana mixes (MOD for the
leader schedule, SHIFT for Turbine).  `ChaCha20Rng` is sequential by nature
(each roll depends on the last) and stays on the host; `chacha20_block_host`
is K18's oracle.

`chacha20_keystream(keys, idxs, nonces)` makes B independent blocks: keys
(32, B) uint8, idxs (B,) int32 or int64 (taken mod 2^32, the u32 block
index), nonces (12, B) uint8 or None (the zero nonce) -> (64, B) uint8.
The plain version runs the rounds on int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kbuild
from .rows import check_rows

_CHACHA20 = kbuild.bind("chacha20_keystream", "fd_chacha20_keystream", 4, (kbuild.I64,))

MASK32 = 0xFFFFFFFF
# "expand 32-byte k" (RFC 7539 constant)
SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _quarter_np(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & MASK32
    s[d] = ((s[d] ^ s[a]) << 16 | (s[d] ^ s[a]) >> 16) & MASK32
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = ((s[b] ^ s[c]) << 12 | (s[b] ^ s[c]) >> 20) & MASK32
    s[a] = (s[a] + s[b]) & MASK32
    s[d] = ((s[d] ^ s[a]) << 8 | (s[d] ^ s[a]) >> 24) & MASK32
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = ((s[b] ^ s[c]) << 7 | (s[b] ^ s[c]) >> 25) & MASK32


_ROUND = [
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
]


def chacha20_block_host(key: bytes, idx: int, nonce: bytes = b"\x00" * 12) -> bytes:
    """One 64-byte block: 32-byte key, u32 block index, 12-byte nonce."""
    state = np.zeros(16, dtype=np.uint64)  # u64 lanes avoid overflow fuss
    state[:4] = SIGMA
    state[4:12] = np.frombuffer(key, dtype="<u4").astype(np.uint64)
    state[12] = idx & MASK32
    state[13:16] = np.frombuffer(nonce, dtype="<u4").astype(np.uint64)
    s = state.copy()
    for _ in range(10):
        for a, b, c, d in _ROUND:
            _quarter_np(s, a, b, c, d)
    out = (s + state) & MASK32
    return out.astype("<u4").tobytes()


# -- batched device path (K18) -------------------------------------------------


def _le_words(rows: torch.Tensor) -> list[torch.Tensor]:
    """(4n, B) uint8 rows -> n (B,) int64 little-endian words."""
    by = rows.to(torch.int64).reshape(rows.shape[0] // 4, 4, rows.shape[1])
    return list((by[:, 0] | (by[:, 1] << 8) | (by[:, 2] << 16) | (by[:, 3] << 24)).unbind(0))


def chacha20_keystream_plain(keys: torch.Tensor, idxs: torch.Tensor,
                             nonces: torch.Tensor | None) -> torch.Tensor:
    """K18's plain version: (32, B) keys, (B,) int32 u32 bit patterns,
    (12, B) nonces or None -> (64, B) uint8."""
    bsz = keys.shape[1]
    init = list(SIGMA) + _le_words(keys) + [idxs.to(torch.int64) & MASK32]
    init += _le_words(nonces) if nonces is not None else [0, 0, 0]
    s = list(init)
    for _ in range(10):
        for a, b, c, d in _ROUND:
            _quarter_np(s, a, b, c, d)
    out = torch.stack([(x + y) & MASK32 for x, y in zip(s, init)])
    sh = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=keys.device).reshape(1, 4, 1)
    return ((out.unsqueeze(1) >> sh) & 0xFF).reshape(64, bsz).to(torch.uint8)


def chacha20_keystream(keys: torch.Tensor, idxs: torch.Tensor,
                       nonces: torch.Tensor | None = None) -> torch.Tensor:
    """K18: B independent 64-byte ChaCha20 blocks -> (64, B) uint8.

    Replaces ops/chacha20.py:65 chacha20_keystream.  keys (32, B) uint8,
    idxs (B,) int32 (the u32 block index's bit pattern), nonces (12, B)
    uint8 or None (zero nonces).  On CPU tensors this runs the plain
    version; on CUDA tensors it launches csrc/chacha20_keystream.cu or
    raises.
    """
    check_rows("chacha20_keystream keys", keys, 32)
    bsz = keys.shape[1]
    if nonces is not None:
        check_rows("chacha20_keystream nonces", nonces, 12, bsz)
    if idxs.dtype != torch.int32 or tuple(idxs.shape) != (bsz,):
        raise ValueError(f"chacha20_keystream: idxs must be ({bsz},) int32,"
                         f" got {tuple(idxs.shape)} {idxs.dtype}")
    devs = {keys.device, idxs.device} | ({nonces.device} if nonces is not None else set())
    if len(devs) != 1:
        raise ValueError(f"chacha20_keystream: inputs on {sorted(map(str, devs))}")
    idxs = idxs.contiguous()
    if keys.device.type == "cpu":
        return chacha20_keystream_plain(keys, idxs, nonces)
    if keys.device.type != "cuda":
        raise ValueError(f"chacha20_keystream: unsupported device {keys.device}")
    out = torch.empty((64, bsz), dtype=torch.uint8, device=keys.device)
    _CHACHA20(keys.device, keys.data_ptr(), idxs.data_ptr(),
              nonces.data_ptr() if nonces is not None else None, out.data_ptr(), bsz)
    return out


# -- the Solana protocol RNG (host, sequential by nature) ---------------------

MODE_MOD = 1    # leader schedule (largest rejection zone)
MODE_SHIFT = 2  # Turbine (power-of-two zone, no mod on the fast path)

U64 = 1 << 64


class ChaCha20Rng:
    """rand_chacha::ChaCha20Rng::from_seed-compatible stream + rolls."""

    def __init__(self, seed: bytes, mode: int = MODE_MOD):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.key = bytes(seed)
        self.mode = mode
        self._block_idx = 0
        self._buf = b""
        self._off = 0

    def _refill(self) -> None:
        self._buf = chacha20_block_host(self.key, self._block_idx)
        self._block_idx += 1
        self._off = 0

    def ulong(self) -> int:
        """Next u64, little-endian off the keystream."""
        if self._off + 8 > len(self._buf):
            self._refill()
        v = int.from_bytes(self._buf[self._off : self._off + 8], "little")
        self._off += 8
        return v

    def ulong_roll(self, n: int) -> int:
        """Unbiased uniform in [0, n): the widening-multiply rejection
        scheme of the Rust rand crate (zone per mode, fd_chacha20rng.h)."""
        if not 0 < n < U64:
            raise ValueError("n out of range")
        if self.mode == MODE_MOD:
            zone = (U64 - 1) - (U64 - n) % n
        else:  # smallest power-of-two k with k*n >= 2^63; fits u64 always
            zone = (n << (63 - (n.bit_length() - 1))) - 1
        while True:
            v = self.ulong()
            res = v * n
            hi, lo = res >> 64, res & (U64 - 1)
            if lo <= zone:
                return hi
