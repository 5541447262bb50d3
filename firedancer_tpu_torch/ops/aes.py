"""AES-128/256 and GCM, QUIC packet protection's cipher (the port's copy of
firedancer_tpu/ops/aes.py).

By default every seal, open and encrypt_block goes through the port's net
library (runtime/net_native.py over native/fd_net.cpp: AES-NI and PCLMUL
where the CPU has them, its scalar path otherwise, byte-identical).  The
pure-Python FIPS-197 cipher and NIST SP 800-38D GCM below (key expansion,
CTR keystream, GHASH over GF(2^128), open rejecting on a tag mismatch) are
the plain version the tests hold the library to; a caller reaches them only
by asking, `Aes(key, native=False)` or `AesGcm(key, native=False)`.  A
failed build of the library raises HostBuildError.
"""

from __future__ import annotations

from ..runtime import net_native

# FIPS-197 S-box (public standard constant)
_SBOX = bytes.fromhex(
    "637c777bf26b6fc53001672bfed7ab76ca82c97dfa5947f0add4a2af9ca472c0"
    "b7fd9326363ff7cc34a5e5f171d8311504c723c31896059a071280e2eb27b275"
    "09832c1a1b6e5aa0523bd6b329e32f8453d100ed20fcb15b6acbbe394a4c58cf"
    "d0efaafb434d338545f9027f503c9fa851a3408f929d38f5bcb6da2110fff3d2"
    "cd0c13ec5f974417c4a77e3d645d197360814fdc222a908846eeb814de5e0bdb"
    "e0323a0a4906245cc2d3ac629195e479e7c8376d8dd54ea96c56f4ea657aae08"
    "ba78252e1ca6b4c6e8dd741f4bbd8b8a703eb5664803f60e613557b986c11d9e"
    "e1f8981169d98e949b1e87e9ce5528df8ca1890dbfe6426841992d0fb054bb16"
)
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C, 0xD8, 0xAB, 0x4D]


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) & 0xFF if a & 0x100 else a


_MUL2 = bytes(_xtime(i) for i in range(256))
_MUL3 = bytes(_xtime(i) ^ i for i in range(256))


def _expand_key(key: bytes) -> list[bytes]:
    nk = len(key) // 4
    if nk not in (4, 8):
        raise ValueError("AES-128 or AES-256 keys only")
    nr = nk + 6
    words = [key[4 * i : 4 * i + 4] for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        t = words[i - 1]
        if i % nk == 0:
            t = bytes(_SBOX[b] for b in t[1:] + t[:1])
            t = bytes([t[0] ^ _RCON[i // nk - 1], t[1], t[2], t[3]])
        elif nk == 8 and i % nk == 4:
            t = bytes(_SBOX[b] for b in t)
        words.append(bytes(a ^ b for a, b in zip(words[i - nk], t)))
    return [b"".join(words[4 * r : 4 * r + 4]) for r in range(nr + 1)]


def _encrypt_block(rks: list[bytes], block: bytes) -> bytes:
    s = bytearray(a ^ b for a, b in zip(block, rks[0]))
    nr = len(rks) - 1
    for rnd in range(1, nr):
        s = bytearray(_SBOX[b] for b in s)
        # shift rows
        s = bytearray(
            s[(i + 4 * (i % 4)) % 16] for i in range(16)
        )
        # mix columns
        out = bytearray(16)
        for c in range(4):
            a0, a1, a2, a3 = s[4 * c : 4 * c + 4]
            out[4 * c + 0] = _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3
            out[4 * c + 1] = a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3
            out[4 * c + 2] = a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3]
            out[4 * c + 3] = _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3]
        s = bytearray(a ^ b for a, b in zip(out, rks[rnd]))
    s = bytearray(_SBOX[b] for b in s)
    s = bytearray(s[(i + 4 * (i % 4)) % 16] for i in range(16))
    return bytes(a ^ b for a, b in zip(s, rks[nr]))


class Aes:
    def __init__(self, key: bytes, *, native: bool = True):
        self._rks = _expand_key(key)  # also validates the key length
        self._key = bytes(key)
        self.native = native

    def encrypt_block(self, block: bytes) -> bytes:
        if len(block) != 16:
            raise ValueError("AES block is 16 bytes")
        if self.native:
            return net_native.aes_ecb_blocks(self._key, block)
        return _encrypt_block(self._rks, block)


# -- GCM ----------------------------------------------------------------------

_R = 0xE1 << 120


def _ghash_mul(x: int, y: int) -> int:
    """GF(2^128) multiply, GCM bit order (SP 800-38D 6.3)."""
    z = 0
    v = y
    for i in range(127, -1, -1):
        if (x >> i) & 1:
            z ^= v
        v = (v >> 1) ^ (_R if v & 1 else 0)
    return z


class AesGcm:
    def __init__(self, key: bytes, *, native: bool = True):
        self._aes = Aes(key, native=native)
        self.native = native
        self._h = None if native else int.from_bytes(self._aes.encrypt_block(b"\x00" * 16), "big")

    def _ghash(self, aad: bytes, ct: bytes) -> int:
        def blocks(data):
            for i in range(0, len(data), 16):
                yield data[i : i + 16].ljust(16, b"\x00")

        y = 0
        for blk in blocks(aad):
            y = _ghash_mul(y ^ int.from_bytes(blk, "big"), self._h)
        for blk in blocks(ct):
            y = _ghash_mul(y ^ int.from_bytes(blk, "big"), self._h)
        lens = (len(aad) * 8).to_bytes(8, "big") + (len(ct) * 8).to_bytes(8, "big")
        return _ghash_mul(y ^ int.from_bytes(lens, "big"), self._h)

    def _ctr(self, j0: bytes, data: bytes) -> bytes:
        out = bytearray()
        ctr = int.from_bytes(j0[12:], "big")
        for i in range(0, len(data), 16):
            ctr = (ctr + 1) & 0xFFFFFFFF
            ks = self._aes.encrypt_block(j0[:12] + ctr.to_bytes(4, "big"))
            chunk = data[i : i + 16]
            out += bytes(a ^ b for a, b in zip(chunk, ks))
        return bytes(out)

    def seal(self, iv: bytes, plaintext: bytes, aad: bytes = b"") -> tuple[bytes, bytes]:
        """-> (ciphertext, 16-byte tag)."""
        if len(iv) != 12:
            raise ValueError("GCM IV must be 96 bits (the QUIC form)")
        if self.native:
            return net_native.gcm_seal(self._aes._key, iv, plaintext, aad)
        j0 = iv + b"\x00\x00\x00\x01"
        ct = self._ctr(j0, plaintext)
        s = self._ghash(aad, ct)
        tag = int.from_bytes(self._aes.encrypt_block(j0), "big") ^ s
        return ct, tag.to_bytes(16, "big")

    def open(self, iv: bytes, ciphertext: bytes, tag: bytes, aad: bytes = b"") -> bytes | None:
        """-> plaintext, or None on authentication failure."""
        if len(iv) != 12 or len(tag) != 16:
            return None
        if self.native:
            return net_native.gcm_open(self._aes._key, iv, ciphertext, tag, aad)
        j0 = iv + b"\x00\x00\x00\x01"
        s = self._ghash(aad, ciphertext)
        expect = (int.from_bytes(self._aes.encrypt_block(j0), "big") ^ s).to_bytes(16, "big")
        diff = 0
        for a, b in zip(expect, tag):
            diff |= a ^ b
        if diff:
            return None
        return self._ctr(j0, ciphertext)
