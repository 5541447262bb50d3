"""Base58 encode/decode (Bitcoin alphabet): the port's copy of
firedancer_tpu/protocol/base58.py (the well-known program ids of pack's
cost table and the executor are written in base58).

Leading zero bytes map to leading '1's and back.
"""


from __future__ import annotations

ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(ALPHABET)}


def b58_encode(data: bytes) -> str:
    zeros = len(data) - len(data.lstrip(b"\x00"))
    n = int.from_bytes(data, "big")
    out = []
    while n:
        n, r = divmod(n, 58)
        out.append(ALPHABET[r])
    return "1" * zeros + "".join(reversed(out))


def b58_decode(s: str, length: int | None = None) -> bytes:
    n = 0
    for c in s:
        if c not in _INDEX:
            raise ValueError(f"invalid base58 char {c!r}")
        n = n * 58 + _INDEX[c]
    zeros = len(s) - len(s.lstrip("1"))
    body = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    out = b"\x00" * zeros + body
    if length is not None:
        if len(out) > length:
            raise ValueError("decoded value too long")
        out = b"\x00" * (length - len(out)) + out
    return out


def b58_encode32(data: bytes) -> str:
    assert len(data) == 32
    return b58_encode(data)


def b58_decode32(s: str) -> bytes:
    return b58_decode(s, length=32)
