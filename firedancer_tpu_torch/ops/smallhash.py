"""Murmur3-32, the hash Solana derives sBPF syscall ids from (the port's
copy of firedancer_tpu/ops/smallhash.py, cut to murmur3_32 and
syscall_id): murmur3_32(b"sol_sha256") == 0x11f49d86, the id the VM
(flamenco/vm.py) registers sol_sha256 under."""

from __future__ import annotations

_M32 = 0xFFFFFFFF


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def murmur3_32(data: bytes, seed: int = 0) -> int:
    h = seed & _M32
    n = len(data)
    for i in range(0, n - n % 4, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * 0xCC9E2D51) & _M32
        k = _rotl32(k, 15)
        k = (k * 0x1B873593) & _M32
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _M32
    tail = data[n - n % 4 :]
    if tail:
        k = int.from_bytes(tail, "little")
        k = (k * 0xCC9E2D51) & _M32
        k = _rotl32(k, 15)
        k = (k * 0x1B873593) & _M32
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def syscall_id(name: str | bytes) -> int:
    """The Solana syscall-id derivation: murmur3_32(name, seed 0)."""
    if isinstance(name, str):
        name = name.encode()
    return murmur3_32(name, 0)
