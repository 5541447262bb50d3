"""Fast non-cryptographic RNG (the port's copy of firedancer_tpu/utils/rng.py,
stream for stream).

splitmix64 seeding into xoshiro256**, with the fd_rng-style API: built from
(seq, idx), identical streams for identical seeds, `ulong` / `uint` /
`roll(n)` (unbiased, by rejection) / `float01` / `shuffle`.  Not for
protocol randomness (that is ops/chacha20.py's job): the stage loop's
housekeeping phase and the restart policy's backoff jitter draw from it.
"""

from __future__ import annotations

_M64 = (1 << 64) - 1


def _splitmix64(x: int):
    while True:
        x = (x + 0x9E3779B97F4A7C15) & _M64
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        yield z ^ (z >> 31)


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _M64


class Rng:
    def __init__(self, seq: int = 0, idx: int = 0):
        # the pair seeds sequentially through splitmix: idx enters keyed by
        # a seq-derived value, so no (seq, idx) pair aliases another
        ga = _splitmix64(seq & _M64)
        gb = _splitmix64((next(ga) ^ idx) & _M64)
        self._s = [next(gb) for _ in range(4)]
        if not any(self._s):  # all-zero state is xoshiro's fixed point
            self._s[0] = 1

    def ulong(self) -> int:
        s = self._s
        result = (_rotl((s[1] * 5) & _M64, 7) * 9) & _M64
        t = (s[1] << 17) & _M64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 45)
        return result

    def uint(self) -> int:
        return self.ulong() >> 32

    def roll(self, n: int) -> int:
        """Unbiased uniform in [0, n)."""
        if not 0 < n <= 1 << 64:
            raise ValueError("n out of range")
        zone = (1 << 64) - (1 << 64) % n
        while True:
            v = self.ulong()
            if v < zone:
                return v % n

    def float01(self) -> float:
        return (self.ulong() >> 11) * (1.0 / (1 << 53))

    def shuffle(self, xs: list) -> list:
        for i in range(len(xs) - 1, 0, -1):
            j = self.roll(i + 1)
            xs[i], xs[j] = xs[j], xs[i]
        return xs
