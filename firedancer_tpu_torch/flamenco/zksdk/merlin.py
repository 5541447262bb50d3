"""Merlin transcripts (STROBE-128 over keccak-f[1600]); the port's copy
of firedancer_tpu/flamenco/zksdk/merlin.py.

Capability parity target: the reference's
zksdk/merlin/fd_merlin.{c,h}, itself a port of zkcrypto/merlin 3.0.0.
No code shared: this is written from the STROBE v1.0.2 specification
(operations lite profile, sec=128 -> R = 166) and merlin's documented
framing (meta-AD of `label || LE32(len)` around each operation), reusing
the repo's keccak-f permutation (ops/keccak256).

Test anchor: merlin 3.0.0's own equivalence vector ("test protocol" /
"some label" / "some data" -> challenge d5a21972...) — the same vector
the reference's test_merlin.c pins.
"""

from __future__ import annotations

from ...ops.keccak256 import _keccak_f_host

STROBE_R = 166  # rate bytes for the 128-bit security profile
FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = self._permute(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    @staticmethod
    def _permute(st: bytearray) -> bytearray:
        lanes = [int.from_bytes(st[8 * i : 8 * i + 8], "little")
                 for i in range(25)]
        lanes = _keccak_f_host(lanes)
        out = bytearray(200)
        for i, v in enumerate(lanes):
            out[8 * i : 8 * i + 8] = v.to_bytes(8, "little")
        return out

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        self.state = self._permute(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for b in data:
            self.state[self.pos] ^= b
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags, "inconsistent continued op"
            return
        assert not (flags & FLAG_T), "transport ops unsupported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


class Transcript:
    """merlin::Transcript semantics."""

    def __init__(self, protocol_label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", protocol_label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(
            label + len(message).to_bytes(4, "little"), False)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, x.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label + n.to_bytes(4, "little"), False)
        return self.strobe.prf(n)
