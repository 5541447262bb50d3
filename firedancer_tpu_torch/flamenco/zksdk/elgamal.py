"""Twisted ElGamal over ristretto255 (the zk-sdk's encryption scheme); the
port's copy of firedancer_tpu/flamenco/zksdk/elgamal.py.

Capability parity target: the reference zksdk's ElGamal layer (Agave
zk-sdk/src/encryption) — no code shared; the scheme is implemented from
its published definition:

    keypair:     secret s (scalar);  pubkey P = s^{-1} * H
    ciphertext:  commitment C = m*G + r*H   (Pedersen commitment)
                 handle     D = r*P
    decryption:  m*G = C - s*D

G is the ristretto basepoint; H is the Pedersen base (hash-to-ristretto
of sha3-512(G), derived in ops/ristretto + verified against the
protocol constant).  Wire format: ciphertext = C || D (32+32 bytes).
"""

from __future__ import annotations

import hashlib

from ...ops import ristretto as ri
from ...ops.ref.ed25519_ref import L, point_add, point_mul

G = ri.BASE_POINT
H = ri.from_uniform_bytes(hashlib.sha3_512(ri.BASE_BYTES).digest())
H_BYTES = ri.encode(H)
assert H_BYTES.hex() == (
    "8c9240b456a9e6dc65c377a1048d745f94a08cdb7f44cbcd7b46f34048871134"
)


def keygen(seed: bytes) -> tuple[int, bytes]:
    """-> (secret scalar, compressed pubkey P = s^-1 H)."""
    s = int.from_bytes(hashlib.sha512(b"zk-elgamal:" + seed).digest(),
                       "little") % L
    if s == 0:
        s = 1
    pub = point_mul(pow(s, L - 2, L), H)
    return s, ri.encode(pub)


def encrypt(pubkey: bytes, amount: int, r: int) -> bytes:
    """-> 64-byte ciphertext C || D for amount under randomness r."""
    p = ri.decode(pubkey)
    c = point_add(point_mul(amount % L, G), point_mul(r % L, H))
    d = point_mul(r % L, p)
    return ri.encode(c) + ri.encode(d)


def commit(amount: int, r: int) -> bytes:
    """Plain Pedersen commitment m*G + r*H."""
    return ri.encode(point_add(point_mul(amount % L, G),
                               point_mul(r % L, H)))


def decrypt_to_point(secret: int, ciphertext: bytes):
    """-> the group element m*G (amount recovery needs a dlog lookup)."""
    c = ri.decode(ciphertext[:32])
    d = ri.decode(ciphertext[32:])
    return point_add(c, point_mul((L - secret) % L, d))
