"""Seeded verify workloads with known answers: a mixed signature batch in
the kernel layout, and a txn stream for the verify pipeline.  Both are made
from a seed with numpy and signed with the port's ed25519_ref, so the same
inputs can go through the JAX package and the port, and the expected masks
and counters are known up front."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ..ops.ref import ed25519_ref as ref
from ..protocol import txn as ft
from ..runtime.benchg import gen_transfer_pool, pool_blockhash, pool_payers
from ..runtime.verify import encode_verified

P = ref.P
L = ref.L

# lane categories of the mixed batch, cycled over the real lanes
CATEGORIES = ("honest", "bad_msg", "bad_r", "high_s", "small_a", "small_r",
              "noncanon_a", "nonsquare_a", "noncanon_r", "nonsquare_r")


def _sqrt_mod(a: int):
    a %= P
    x = pow(a, (P + 3) // 8, P)
    if (x * x - a) % P:
        x = x * ref.SQRT_M1 % P
    return x if (x * x - a) % P == 0 else None


def torsion_encodings() -> list[bytes]:
    """Encodings of the 8-torsion points (identity y=1, order 2 y=-1,
    order 4 y=0, order 8 from d y^4 + 2 y^2 - 1 = 0)."""
    ys = [1, P - 1, 0]
    s = _sqrt_mod(1 + ref.D)
    for r in (s, P - s):
        y = _sqrt_mod((r - 1) * pow(ref.D, P - 2, P))
        if y is not None:
            ys += [y, P - y]
    return [y.to_bytes(32, "little") for y in ys]


def noncanonical_encodings() -> list[bytes]:
    """y in [p, 2^255) that decompress (the value y - p is a valid y)."""
    out = []
    for y in range(P, 1 << 255):
        enc = y.to_bytes(32, "little")
        if ref.point_decompress(enc) is not None:
            out.append(enc)
    return out


def nonsquare_encodings(n: int = 4) -> list[bytes]:
    """Small y whose x^2 is not a square: not curve points."""
    out, v = [], 2
    while len(out) < n:
        enc = v.to_bytes(32, "little")
        if ref.point_decompress(enc) is None:
            out.append(enc)
        v += 1
    return out


@dataclass
class MixedBatch:
    msg: np.ndarray      # (max_msg_len, B) uint8
    msg_len: np.ndarray  # (B,) int32
    sig: np.ndarray      # (64, B) uint8
    pubkey: np.ndarray   # (32, B) uint8
    n_real: int
    categories: list     # per lane ("pad" past n_real)
    labels: np.ndarray   # (B,) bool: ed25519_ref.verify, False past n_real


def mixed_batch(batch: int, max_msg_len: int, n_real: int | None = None,
                seed: int = 0, n_keys: int = 64) -> MixedBatch:
    """Honest signatures, corrupted messages, corrupted R, high s,
    small-order A and R, non-canonical y, non-square y, and pad lanes past
    n_real (filled with honest triples, so the pad mask matters)."""
    n_real = batch if n_real is None else n_real
    rng = np.random.default_rng(seed)
    tors, nonc, nsq = torsion_encodings(), noncanonical_encodings(), nonsquare_encodings()
    keys = []
    for k in range(min(n_keys, batch)):
        secret = hashlib.sha256(b"mixed%d/%d" % (seed, k)).digest()
        keys.append((secret, ref.public_key(secret)))
    msg = np.zeros((max_msg_len, batch), dtype=np.uint8)
    msg_len = np.zeros((batch,), dtype=np.int32)
    sig = np.zeros((64, batch), dtype=np.uint8)
    pk = np.zeros((32, batch), dtype=np.uint8)
    cats, labels = [], np.zeros((batch,), dtype=bool)
    for i in range(batch):
        cat = CATEGORIES[i % len(CATEGORIES)] if i < n_real else "pad"
        secret, pub = keys[i % len(keys)]
        n = int(rng.integers(1, max_msg_len + 1))
        m = rng.bytes(n)
        s = ref.sign(secret, m)
        if cat == "bad_msg":
            m = m[:-1] + bytes([m[-1] ^ 0x01])
        elif cat == "bad_r":
            s = bytes([s[0] ^ 0x04]) + s[1:]
        elif cat == "high_s":
            s = s[:32] + (int.from_bytes(s[32:], "little") + L).to_bytes(32, "little")
        elif cat == "small_a":
            pub = tors[i % len(tors)]
        elif cat == "small_r":
            s = tors[i % len(tors)] + s[32:]
        elif cat == "noncanon_a":
            pub = nonc[i % len(nonc)]
        elif cat == "nonsquare_a":
            pub = nsq[i % len(nsq)]
        elif cat == "noncanon_r":
            s = nonc[i % len(nonc)] + s[32:]
        elif cat == "nonsquare_r":
            s = nsq[i % len(nsq)] + s[32:]
        msg[:n, i] = np.frombuffer(m, dtype=np.uint8)
        msg_len[i] = n
        sig[:, i] = np.frombuffer(s, dtype=np.uint8)
        pk[:, i] = np.frombuffer(pub, dtype=np.uint8)
        cats.append(cat)
        labels[i] = i < n_real and ref.verify(m, s, pub)
    return MixedBatch(msg, msg_len, sig, pk, n_real, cats, labels)


# -- the pipeline stream -------------------------------------------------------------

def multisig_txn(secrets: list[bytes], pubs: list[bytes], blockhash: bytes,
                 nonce: int, bad_sig: int | None = None) -> bytes:
    """A legacy txn signed by every key in `pubs` (one instruction naming
    the first signer), built with message_build and txn_assemble.  With
    bad_sig=j, signature j is over a different message."""
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=len(pubs), readonly_signed_cnt=0,
        readonly_unsigned_cnt=0, acct_addrs=list(pubs),
        recent_blockhash=blockhash,
        instrs=[ft.InstrSpec(program_id=1, accounts=bytes([0]),
                             data=nonce.to_bytes(4, "little"))],
    )
    sigs = [ref.sign(sk, msg if j != bad_sig else msg + b"x")
            for j, sk in enumerate(secrets)]
    return ft.txn_assemble(sigs, msg)


@dataclass
class VerifyStream:
    stream: list          # frames in send order
    expect_sunk: list     # verified frames the sink must hold, in order
    expect: dict          # counter name -> expected value


def verify_stream(n_transfers: int, *, seed: bytes = b"benchg",
                  self_transfer: bool = False, n_multisig: int = 3,
                  n_corrupt: int = 3, n_resend: int = 3,
                  n_long: int = 0) -> VerifyStream:
    """Honest transfers (benchg's pool, or 1-sig self-transfers whose
    118-byte message fits max_msg_len 128), good and bad multi-sig txns,
    corrupted txns, malformed frames, a duplicate inside the verify tile's
    16-deep tcache, transfers with the 150-byte message (msg_too_long when
    max_msg_len < 150), and resent duplicates past the tile tcache that
    only the global dedup stage catches."""
    n_all = n_transfers + n_corrupt
    if self_transfer:
        payers = pool_payers(seed, max(1, min(8, n_all)))
        bh = pool_blockhash(seed)
        all_honest = [ft.transfer_txn(payers[i % len(payers)][0],
                                      payers[i % len(payers)][1], 1 + i, bh,
                                      from_pubkey=payers[i % len(payers)][1])
                      for i in range(n_all)]
        long_txns = gen_transfer_pool(n_long, seed=seed + b"long") if n_long else []
    else:
        all_honest = gen_transfer_pool(n_all, seed=seed)
        long_txns = []
    honest = all_honest[:n_transfers]
    keys = [hashlib.sha256(seed + b"multi%d" % k).digest() for k in range(3)]
    pubs = [ref.public_key(k) for k in keys]
    bh = pool_blockhash(seed)
    # 2 signers keep the message under 128 bytes; 3 signers do not
    n_sign = [2 if self_transfer else 2 + (j % 2) for j in range(n_multisig)]
    multi = [multisig_txn(keys[:n_sign[j]], pubs[:n_sign[j]], bh, j)
             for j in range(n_multisig)]
    bad_multi = multisig_txn(keys[:2], pubs[:2], bh, 999, bad_sig=1)
    # corrupted copies of txns never sent intact (a corrupted copy of a sent
    # txn shares its first signature and would hit the tile tcache)
    corrupt = []
    for p in all_honest[n_transfers:]:
        p = bytearray(p)
        p[-1] ^= 0x01  # last byte of the signed message (lamports)
        corrupt.append(bytes(p))
    malformed = [b"\x01" + b"garbage" * 12, b""]

    stream = list(honest[: n_transfers // 2])
    stream.insert(3, honest[2])  # duplicate inside the tile tcache window
    stream += multi + [bad_multi] + corrupt + malformed + long_txns
    stream += honest[n_transfers // 2:]
    stream += honest[:n_resend]  # resent past the tile tcache
    good = set(honest) | set(multi)
    seen, sunk = set(), []
    for p in stream:
        if p in good and p not in seen:
            seen.add(p)
            sunk.append(encode_verified(p, ft.txn_parse(p)))
    expect = {
        "txn_verified": len(honest) + len(multi) + n_resend,
        "verify_fail": n_corrupt + 1,
        "parse_fail": len(malformed),
        "tile_dedup_dup": 1,
        "msg_too_long": len(long_txns),
        "dedup_dup": n_resend,
        "sunk": len(sunk),
    }
    return VerifyStream(stream, sunk, expect)
