"""Batched scalar arithmetic mod L (the ed25519 group order), plain PyTorch.

Verify needs (a) s < L (the malleability rule, fd_curve25519_scalar_validate)
and (b) the 512-bit SHA-512 output reduced mod L.  The reduction is ref10's
sc_reduce: 24 signed limbs of 21 bits in int64, folded at 2^252 with
2^252 = -C (mod L).  csrc/curve.cuh runs the same sequence per lane.

Layout: scalars are (12, *batch) int64 limbs of 21 bits (limb 11 holds
bits 231..255); byte rows are (nbytes, *batch), batch trailing.
"""

from __future__ import annotations

import torch

from .limbs import bits_from_bytes

L = 2**252 + 27742317777372353535851937790883648493
RADIX = 21
NLIMB = 12
_L_BYTES = L.to_bytes(32, "little")
# -C in signed radix-2^21 limbs: sum(c_j 2^(21 j)) = -(L - 2^252)
_FOLD = (666643, 470296, 654183, -997805, 136657, -683901)


def sc_frombytes(b: torch.Tensor) -> torch.Tensor:
    """(32, *batch) little-endian bytes -> (12, *batch) raw limbs."""
    b = b.to(torch.int64)
    return torch.stack([bits_from_bytes(b, RADIX * i, RADIX if i < 11 else 25)
                        for i in range(NLIMB)])


def sc_tobytes(s: torch.Tensor) -> torch.Tensor:
    """(12, *batch) non-negative limbs -> (32, *batch) bytes (int64)."""
    out = []
    for k in range(32):
        v = None
        for i in range(NLIMB):
            lo = RADIX * i
            if lo >= 8 * k + 8 or lo + 25 <= 8 * k:
                continue
            sh = lo - 8 * k
            t = s[i] << sh if sh >= 0 else s[i] >> -sh
            v = t if v is None else v | t
        out.append(v & 0xFF)
    return torch.stack(out)


def sc_validate(b: torch.Tensor) -> torch.Tensor:
    """(32, *batch) bytes -> bool: value < L.  A borrow chain over the
    bytes of value - L: a final borrow means value < L."""
    b = b.to(torch.int64)
    borrow = torch.zeros_like(b[0])
    for i in range(32):
        borrow = (b[i] - _L_BYTES[i] - borrow < 0).to(torch.int64)
    return borrow == 1


def _fold(s: list, k: int) -> None:
    for j, c in enumerate(_FOLD):
        s[k - 12 + j] = s[k - 12 + j] + s[k] * c
    s[k] = torch.zeros_like(s[k])


def _carry_round(s: list, i: int) -> None:
    c = (s[i] + (1 << 20)) >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - c * (1 << 21)


def _carry_floor(s: list, i: int) -> None:
    c = s[i] >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - c * (1 << 21)


def sc_reduce512(b: torch.Tensor) -> torch.Tensor:
    """(64, *batch) little-endian bytes -> (12, *batch) limbs in [0, L)."""
    b = b.to(torch.int64)
    s = [bits_from_bytes(b, RADIX * i, RADIX if i < 23 else 29)
         for i in range(24)]
    for k in range(23, 17, -1):
        _fold(s, k)
    for i in range(6, 17, 2):
        _carry_round(s, i)
    for i in range(7, 16, 2):
        _carry_round(s, i)
    for k in range(17, 11, -1):
        _fold(s, k)
    for i in range(0, 11, 2):
        _carry_round(s, i)
    for i in range(1, 12, 2):
        _carry_round(s, i)
    _fold(s, 12)
    for i in range(12):
        _carry_floor(s, i)
    _fold(s, 12)
    for i in range(11):
        _carry_floor(s, i)
    return torch.stack(s[:NLIMB])


def sc_bits(s: torch.Tensor, nbits: int = 253) -> torch.Tensor:
    """(12, *batch) limbs -> (nbits, *batch) int64 bits, little-endian."""
    rows = []
    for i in range(nbits):
        k = min(i // RADIX, NLIMB - 1)  # limb 11 holds bits 231..255
        rows.append((s[k] >> (i - RADIX * k)) & 1)
    return torch.stack(rows)


def sc_windows(s: torch.Tensor) -> torch.Tensor:
    """(12, *batch) limbs -> (64, *batch) 4-bit windows, least significant
    first (what the windowed double-scalar multiply consumes)."""
    b = sc_tobytes(s)
    return torch.stack([(b[j >> 1] >> (4 * (j & 1))) & 15 for j in range(64)])
