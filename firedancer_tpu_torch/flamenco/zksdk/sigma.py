"""The zk-sdk sigma proofs: verifiers (consensus surface) + provers; the
port's copy of firedancer_tpu/flamenco/zksdk/sigma.py.

Capability parity target: the reference's zksdk/instructions/*.c —
each verifier below names its counterpart and implements the SAME
verification equation and transcript protocol (Agave
zk-sdk/src/sigma_proofs), over ops/ristretto and the merlin transcript.
No code shared: the multiscalar equations are re-derived from the
protocol comments and checked by round-tripping our own provers plus
the real-transaction fixture embedded in the reference's test suite.

All functions raise ZkError on malformed input and return None on
success (verification failure also raises — callers map to the typed
instruction error).
"""

from __future__ import annotations

from .elgamal import G, H
from .merlin import Transcript
from ...ops import ristretto as ri
from ...ops.ref.ed25519_ref import L, point_mul

ZERO32 = bytes(32)


class ZkError(ValueError):
    pass


# -- transcript conventions (zksdk/transcript/fd_zksdk_transcript.h) ----------


def scalar_validate(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= L:
        raise ZkError("non-canonical scalar")
    return v


def challenge_scalar(t: Transcript, label: bytes) -> int:
    return int.from_bytes(t.challenge_bytes(label, 64), "little") % L


def validate_and_append_point(t: Transcript, label: bytes, p: bytes) -> None:
    if p == ZERO32:
        raise ZkError("identity point in transcript")
    t.append_message(label, p)


def decompress(b: bytes):
    try:
        return ri.decode(b)
    except ri.RistrettoError as e:
        raise ZkError(f"bad point: {e}") from e


def msm(scalars: list[int], points: list) -> object:
    return ri.multiscalar_mul(scalars, points)


def _check(res, expect) -> None:
    if not ri.eq(res, expect):
        raise ZkError("proof verification failed")


# -- pubkey validity (fd_zksdk_pubkey_validity.c) -----------------------------
# context: pubkey 32 | proof: Y 32, z 32.  Equation: z H == c P + Y.


def verify_pubkey_validity(context: bytes, proof: bytes) -> None:
    if len(context) != 32 or len(proof) != 64:
        raise ZkError("bad sizes")
    pubkey, y_bytes, z_bytes = context, proof[:32], proof[32:]
    z = scalar_validate(z_bytes)
    p = decompress(pubkey)
    y = decompress(y_bytes)
    t = Transcript(b"pubkey-validity-instruction")
    t.append_message(b"pubkey", pubkey)
    t.append_message(b"dom-sep", b"pubkey-proof")
    validate_and_append_point(t, b"Y", y_bytes)
    c = challenge_scalar(t, b"c")
    _check(msm([z, L - c], [H, p]), y)


def prove_pubkey_validity(secret: int, pubkey: bytes, rnd: bytes) -> bytes:
    """Prover (client side): knows s with P = s^-1 H."""
    import hashlib

    s_inv = pow(secret, L - 2, L)
    k = int.from_bytes(hashlib.sha512(b"pkv:" + rnd).digest(), "little") % L
    y_bytes = ri.encode(point_mul(k, H))
    t = Transcript(b"pubkey-validity-instruction")
    t.append_message(b"pubkey", pubkey)
    t.append_message(b"dom-sep", b"pubkey-proof")
    validate_and_append_point(t, b"Y", y_bytes)
    c = challenge_scalar(t, b"c")
    z = (c * s_inv + k) % L
    return y_bytes + z.to_bytes(32, "little")


# -- zero ciphertext (fd_zksdk_zero_ciphertext.c) -----------------------------
# context: pubkey 32 | ciphertext 64.  proof: Y_P 32 | Y_D 32 | z 32.
# Equations: (z P == c H + Y_P) * 1;  (z D == c C + Y_D) * w.


def _zero_ciphertext_transcript(pubkey: bytes, ciphertext: bytes) -> Transcript:
    t = Transcript(b"zero-ciphertext-instruction")
    t.append_message(b"pubkey", pubkey)
    t.append_message(b"ciphertext", ciphertext)
    t.append_message(b"dom-sep", b"zero-ciphertext-proof")
    return t


def verify_zero_ciphertext(context: bytes, proof: bytes) -> None:
    if len(context) != 96 or len(proof) != 96:
        raise ZkError("bad sizes")
    pubkey, ciphertext = context[:32], context[32:]
    yp_b, yd_b, z_b = proof[:32], proof[32:64], proof[64:]
    z = scalar_validate(z_b)
    p = decompress(pubkey)
    cc = decompress(ciphertext[:32])
    d = decompress(ciphertext[32:])
    yd = decompress(yd_b)
    yp = decompress(yp_b)
    t = _zero_ciphertext_transcript(pubkey, ciphertext)
    validate_and_append_point(t, b"Y_P", yp_b)
    t.append_message(b"Y_D", yd_b)
    c = challenge_scalar(t, b"c")
    w = challenge_scalar(t, b"w")
    _check(
        msm([L - c, z, (L - c) * w % L, w * z % L, L - w],
            [H, p, cc, d, yd]),
        yp,
    )


def prove_zero_ciphertext(secret: int, pubkey: bytes, ciphertext: bytes,
                          rnd: bytes) -> bytes:
    """Knows s with H = s P and D s = r H (ciphertext of 0: C = r H)."""
    import hashlib

    p = decompress(pubkey)
    d = decompress(ciphertext[32:])
    k = int.from_bytes(hashlib.sha512(b"zc:" + rnd).digest(), "little") % L
    yp_b = ri.encode(point_mul(k, p))
    yd_b = ri.encode(point_mul(k, d))
    t = _zero_ciphertext_transcript(pubkey, ciphertext)
    validate_and_append_point(t, b"Y_P", yp_b)
    t.append_message(b"Y_D", yd_b)
    c = challenge_scalar(t, b"c")
    z = (c * secret + k) % L
    return yp_b + yd_b + z.to_bytes(32, "little")


# -- ciphertext-commitment equality (fd_zksdk_ciphertext_commitment_equality.c)
# context: pubkey 32 | ciphertext 64 | commitment 32.
# proof: Y_0 Y_1 Y_2 | z_s z_x z_r.
# Equations: (z_s P == c H + Y_0) * w^2
#            (z_x G + z_s D == c C + Y_1) * w
#            (z_x G + z_r H == c C_dst + Y_2) * 1


def verify_ciphertext_commitment_equality(context: bytes,
                                          proof: bytes) -> None:
    if len(context) != 128 or len(proof) != 192:
        raise ZkError("bad sizes")
    pubkey, ciphertext, commitment = (
        context[:32], context[32:96], context[96:])
    y0_b, y1_b, y2_b = proof[:32], proof[32:64], proof[64:96]
    zs = scalar_validate(proof[96:128])
    zx = scalar_validate(proof[128:160])
    zr = scalar_validate(proof[160:192])
    p = decompress(pubkey)
    c_src = decompress(ciphertext[:32])
    d_src = decompress(ciphertext[32:])
    c_dst = decompress(commitment)
    y0 = decompress(y0_b)
    y1 = decompress(y1_b)
    y2 = decompress(y2_b)
    t = Transcript(b"ciphertext-commitment-equality-instruction")
    t.append_message(b"pubkey", pubkey)
    t.append_message(b"ciphertext", ciphertext)
    t.append_message(b"commitment", commitment)
    t.append_message(b"dom-sep", b"ciphertext-commitment-equality-proof")
    validate_and_append_point(t, b"Y_0", y0_b)
    validate_and_append_point(t, b"Y_1", y1_b)
    validate_and_append_point(t, b"Y_2", y2_b)
    c = challenge_scalar(t, b"c")
    w = challenge_scalar(t, b"w")
    ww = w * w % L
    _check(
        msm(
            [
                (zx * w + zx) % L,            # G
                (zr - c * ww) % L,            # H
                (L - ww) % L,                 # Y_0
                (L - w) % L,                  # Y_1
                zs * ww % L,                  # P_src
                (L - c) * w % L,              # C_src
                zs * w % L,                   # D_src
                (L - c) % L,                  # C_dst
            ],
            [G, H, y0, y1, p, c_src, d_src, c_dst],
        ),
        y2,
    )


# -- ciphertext-ciphertext equality (fd_zksdk_ciphertext_ciphertext_equality.c)
# context: pk1 32 | pk2 32 | ct1 64 | ct2 64.
# proof: Y_0..Y_3 | z_s z_x z_r.


def verify_ciphertext_ciphertext_equality(context: bytes,
                                          proof: bytes) -> None:
    if len(context) != 192 or len(proof) != 224:
        raise ZkError("bad sizes")
    pk1, pk2 = context[:32], context[32:64]
    ct1, ct2 = context[64:128], context[128:192]
    y_b = [proof[32 * i : 32 * (i + 1)] for i in range(4)]
    zs = scalar_validate(proof[128:160])
    zx = scalar_validate(proof[160:192])
    zr = scalar_validate(proof[192:224])
    p1 = decompress(pk1)
    p2 = decompress(pk2)
    c1, d1 = decompress(ct1[:32]), decompress(ct1[32:])
    c2, d2 = decompress(ct2[:32]), decompress(ct2[32:])
    y = [decompress(b) for b in y_b]
    t = Transcript(b"ciphertext-ciphertext-equality-instruction")
    t.append_message(b"first-pubkey", pk1)
    t.append_message(b"second-pubkey", pk2)
    t.append_message(b"first-ciphertext", ct1)
    t.append_message(b"second-ciphertext", ct2)
    t.append_message(b"dom-sep", b"ciphertext-ciphertext-equality-proof")
    for i in range(4):
        validate_and_append_point(t, b"Y_%d" % i, y_b[i])
    c = challenge_scalar(t, b"c")
    w = challenge_scalar(t, b"w")
    ww = w * w % L
    www = ww * w % L
    _check(
        msm(
            [
                zx * (w + ww) % L,        # G
                (zr * ww - c) % L,        # H
                zs,                       # P1
                zs * w % L,               # D1
                (L - w) % L,              # Y_1
                (L - w) * c % L,          # C1
                (L - ww) % L,             # Y_2
                (L - ww) * c % L,         # C2
                (L - www) % L,            # Y_3
                (L - www) * c % L,        # D2
                www * zr % L,             # P2
            ],
            [G, H, p1, d1, y[1], c1, y[2], c2, y[3], d2, p2],
        ),
        y[0],
    )


# -- percentage with cap (fd_zksdk_percentage_with_cap.c) ---------------------
# context: percentage_commitment 32 | delta_commitment 32 |
#          claimed_commitment 32 | max_value u64 LE.
# proof: (y_max 32 | z_max 32 | c_max 32) + (y_delta 32 | y_claimed 32 |
#         z_x 32 | z_delta 32 | z_claimed 32)


def verify_percentage_with_cap(context: bytes, proof: bytes) -> None:
    if len(context) != 104 or len(proof) != 256:
        raise ZkError("bad sizes")
    c_max_comm, c_delta_comm, c_claim_comm = (
        context[:32], context[32:64], context[64:96])
    max_value = int.from_bytes(context[96:104], "little")
    y_max_b = proof[:32]
    z_max = scalar_validate(proof[32:64])
    c_max = scalar_validate(proof[64:96])
    y_delta_b = proof[96:128]
    y_claim_b = proof[128:160]
    z_x = scalar_validate(proof[160:192])
    z_delta = scalar_validate(proof[192:224])
    z_claimed = scalar_validate(proof[224:256])
    pts = [decompress(b) for b in
           (c_max_comm, y_delta_b, c_delta_comm, y_claim_b, c_claim_comm,
            y_max_b)]
    p_max, y_delta, c_delta, y_claim, c_claim, y_max = pts
    t = Transcript(b"percentage-with-cap-instruction")
    t.append_message(b"percentage-commitment", c_max_comm)
    t.append_message(b"delta-commitment", c_delta_comm)
    t.append_message(b"claimed-commitment", c_claim_comm)
    t.append_u64(b"max-value", max_value)
    t.append_message(b"dom-sep", b"percentage-with-cap-proof")
    validate_and_append_point(t, b"Y_max_proof", y_max_b)
    validate_and_append_point(t, b"Y_delta", y_delta_b)
    validate_and_append_point(t, b"Y_claimed", y_claim_b)
    c = challenge_scalar(t, b"c")
    w = challenge_scalar(t, b"w")
    ww = w * w % L
    c_eq = (c - c_max) % L
    _check(
        msm(
            [
                (c_max * max_value - (w + ww) * z_x) % L,        # G
                (z_max - (w * z_delta + ww * z_claimed)) % L,    # H
                (L - c_max) % L,                                 # C_max
                w,                                               # Y_delta
                w * c_eq % L,                                    # C_delta
                ww,                                              # Y_claim
                ww * c_eq % L,                                   # C_claim
            ],
            [G, H, p_max, y_delta, c_delta, y_claim, c_claim],
        ),
        y_max,
    )


# -- grouped-ciphertext validity, 2/3 handles, plain + batched ----------------
# (fd_zksdk_batched_grouped_ciphertext_{2,3}_handles_validity.c)


def _grouped_verify(
    pubkeys: list[bytes],
    comm: bytes,
    handles: list[bytes],
    comm_hi: bytes | None,
    handles_hi: list[bytes] | None,
    proof: bytes,
    transcript: Transcript,
    batched: bool,
) -> None:
    n = len(pubkeys)
    y_b = [proof[32 * i : 32 * (i + 1)] for i in range(n + 1)]
    zr = scalar_validate(proof[32 * (n + 1) : 32 * (n + 2)])
    zx = scalar_validate(proof[32 * (n + 2) : 32 * (n + 3)])

    pubkey_n_zero = n == 2 and pubkeys[-1] == ZERO32
    if pubkey_n_zero:
        # last pubkey zero: its handle(s) and Y must be zero too
        if handles[-1] != ZERO32 or y_b[-1] != ZERO32 or (
            batched and handles_hi[-1] != ZERO32
        ):
            raise ZkError("zero-pubkey consistency")

    y0 = decompress(y_b[0])
    points = [G, H]
    scalars: list[int] = []

    tcr = transcript
    t_chal = 0
    if batched:
        tcr.append_message(b"dom-sep", b"batched-validity-proof")
        tcr.append_u64(b"handles", n)
        t_chal = challenge_scalar(tcr, b"t")
    tcr.append_message(b"dom-sep", b"validity-proof")
    tcr.append_u64(b"handles", n)
    validate_and_append_point(tcr, b"Y_0", y_b[0])
    validate_and_append_point(tcr, b"Y_1", y_b[1])
    if n == 2:
        tcr.append_message(b"Y_2", y_b[2])  # may be zero
    else:
        validate_and_append_point(tcr, b"Y_2", y_b[2])
        tcr.append_message(b"Y_3", y_b[3])  # may be zero
    c = challenge_scalar(tcr, b"c")
    w = challenge_scalar(tcr, b"w")

    # base MSM: G z_x + H z_r + Σ_i (pub_i z_r w^i + Y_i (-w^i) + h_i (-c w^i))
    # + C (-c) [+ batched hi-terms scaled by t]
    scalars = [zx, zr]
    points = [G, H]
    scalars.append((L - c) % L)
    points.append(decompress(comm))
    wi = 1
    for i in range(n):
        if n == 2 and i == n - 1 and pubkey_n_zero:
            break
        wi = wi * w % L
        scalars.append(zr * wi % L)
        points.append(decompress(pubkeys[i]))
        scalars.append((L - wi) % L)
        points.append(decompress(y_b[i + 1]))
        scalars.append((L - c) * wi % L)
        points.append(decompress(handles[i]))
    if batched:
        scalars.append((L - c) * t_chal % L)
        points.append(decompress(comm_hi))
        wi = 1
        for i in range(n):
            if n == 2 and i == n - 1 and pubkey_n_zero:
                break
            wi = wi * w % L
            scalars.append((L - c) * wi % L * t_chal % L)
            points.append(decompress(handles_hi[i]))
    _check(msm(scalars, points), y0)


def verify_grouped_ciphertext_2_handles_validity(context: bytes,
                                                 proof: bytes) -> None:
    if len(context) != 160 or len(proof) != 160:
        raise ZkError("bad sizes")
    pk1, pk2, gc = context[:32], context[32:64], context[64:]
    t = Transcript(b"grouped-ciphertext-validity-2-handles-instruction")
    t.append_message(b"first-pubkey", pk1)
    t.append_message(b"second-pubkey", pk2)
    t.append_message(b"grouped-ciphertext", gc)
    _grouped_verify([pk1, pk2], gc[:32], [gc[32:64], gc[64:96]],
                    None, None, proof, t, batched=False)


def verify_batched_grouped_ciphertext_2_handles_validity(
    context: bytes, proof: bytes
) -> None:
    if len(context) != 256 or len(proof) != 160:
        raise ZkError("bad sizes")
    pk1, pk2 = context[:32], context[32:64]
    lo, hi = context[64:160], context[160:256]
    t = Transcript(
        b"batched-grouped-ciphertext-validity-2-handles-instruction")
    t.append_message(b"first-pubkey", pk1)
    t.append_message(b"second-pubkey", pk2)
    t.append_message(b"grouped-ciphertext-lo", lo)
    t.append_message(b"grouped-ciphertext-hi", hi)
    _grouped_verify([pk1, pk2], lo[:32], [lo[32:64], lo[64:96]],
                    hi[:32], [hi[32:64], hi[64:96]], proof, t,
                    batched=True)


def verify_grouped_ciphertext_3_handles_validity(context: bytes,
                                                 proof: bytes) -> None:
    if len(context) != 224 or len(proof) != 192:
        raise ZkError("bad sizes")
    pk1, pk2, pk3, gc = (context[:32], context[32:64], context[64:96],
                         context[96:])
    t = Transcript(b"grouped-ciphertext-validity-3-handles-instruction")
    t.append_message(b"first-pubkey", pk1)
    t.append_message(b"second-pubkey", pk2)
    t.append_message(b"third-pubkey", pk3)
    t.append_message(b"grouped-ciphertext", gc)
    _grouped_verify([pk1, pk2, pk3], gc[:32],
                    [gc[32:64], gc[64:96], gc[96:128]],
                    None, None, proof, t, batched=False)


def verify_batched_grouped_ciphertext_3_handles_validity(
    context: bytes, proof: bytes
) -> None:
    if len(context) != 352 or len(proof) != 192:
        raise ZkError("bad sizes")
    pk1, pk2, pk3 = context[:32], context[32:64], context[64:96]
    lo, hi = context[96:224], context[224:352]
    t = Transcript(
        b"batched-grouped-ciphertext-validity-3-handles-instruction")
    t.append_message(b"first-pubkey", pk1)
    t.append_message(b"second-pubkey", pk2)
    t.append_message(b"third-pubkey", pk3)
    t.append_message(b"grouped-ciphertext-lo", lo)
    t.append_message(b"grouped-ciphertext-hi", hi)
    _grouped_verify([pk1, pk2, pk3], lo[:32],
                    [lo[32:64], lo[64:96], lo[96:128]],
                    hi[:32], [hi[32:64], hi[64:96], hi[96:128]],
                    proof, t, batched=True)
