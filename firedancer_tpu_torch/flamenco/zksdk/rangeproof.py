"""Bulletproof batched range proofs (the zk-sdk's u64/u128/u256 family);
the port's copy of firedancer_tpu/flamenco/zksdk/rangeproof.py.

Capability parity target: the reference's
zksdk/rangeproofs/fd_rangeproofs.c (itself following Agave
zk-sdk/src/range_proof, the dalek bulletproofs protocol).  No code
shared: the verifier below implements the same single-MSM verification
equation (res == -A) and transcript protocol, re-derived from the
protocol; the prover is the standard aggregated bulletproof prover
(needed for tests and the client side — Agave's zk-sdk ships one too).

Generators: the dalek `GeneratorsChain` derivation — shake256 of
"GeneratorsChain" || label, 64 XOF bytes per point through the
ristretto one-way map; our chain reproduces the reference's table
(G[0] = e4d54971..., H[0] = 5a85e848...) exactly.

Wire format (all 32-byte LE):
    range_proof: A S T_1 T_2 | t_x t_x_blinding e_blinding
    ipp:         (L_i R_i) * logn | a b
"""

from __future__ import annotations

import hashlib

from .elgamal import G, H
from .merlin import Transcript
from .sigma import (
    ZkError,
    challenge_scalar,
    decompress,
    msm,
    scalar_validate,
    validate_and_append_point,
)
from ...ops import ristretto as ri
from ...ops.ref.ed25519_ref import (
    IDENT,
    L,
    point_add,
    point_mul,
    point_neg,
)

MAX_COMMITMENTS = 8
MAX_NM = 256


def _gen_chain(label: bytes, n: int) -> list:
    sh = hashlib.shake_256()
    sh.update(b"GeneratorsChain" + label)
    stream = sh.digest(64 * n)
    return [ri.from_uniform_bytes(stream[64 * i : 64 * (i + 1)])
            for i in range(n)]


_GENS: dict[str, list] = {}


def generators(n: int) -> tuple[list, list]:
    if not _GENS:
        _GENS["G"] = _gen_chain(b"G", MAX_NM)
        _GENS["H"] = _gen_chain(b"H", MAX_NM)
    return _GENS["G"][:n], _GENS["H"][:n]


def _delta(nm: int, y: int, z: int, bit_lengths: list[int]) -> int:
    """(z - z^2) * sum_{j<nm} y^j - sum_i z^{3+i} (2^{b_i} - 1)."""
    sum_y = 0
    yj = 1
    for _ in range(nm):
        sum_y = (sum_y + yj) % L
        yj = yj * y % L
    zz = z * z % L
    d = (z - zz) % L * sum_y % L
    exp_z = zz
    for b in bit_lengths:
        exp_z = exp_z * z % L
        d = (d - exp_z * ((1 << b) - 1)) % L
    return d


def _validate_bits(b: int) -> None:
    if b not in (1, 2, 4, 8, 16, 32, 64, 128):
        raise ZkError(f"bad bit length {b}")


def verify_range_proof(
    commitments: list[bytes],
    bit_lengths: list[int],
    proof: bytes,
    transcript: Transcript,
    logn: int,
) -> None:
    """The single-MSM batched verification (fd_rangeproofs_verify)."""
    n = 1 << logn
    if len(proof) != 224 + 64 * logn + 64:
        raise ZkError("bad range proof size")
    for b in bit_lengths:
        _validate_bits(b)
    nm = sum(bit_lengths)
    if nm != n:
        raise ZkError("bit lengths do not sum to the proof size")

    a_b, s_b, t1_b, t2_b = (proof[:32], proof[32:64], proof[64:96],
                            proof[96:128])
    tx = scalar_validate(proof[128:160])
    txb = scalar_validate(proof[160:192])
    eb = scalar_validate(proof[192:224])
    lr = proof[224 : 224 + 64 * logn]
    l_b = [lr[64 * i : 64 * i + 32] for i in range(logn)]
    r_b = [lr[64 * i + 32 : 64 * i + 64] for i in range(logn)]
    a_sc = scalar_validate(proof[224 + 64 * logn : 256 + 64 * logn])
    b_sc = scalar_validate(proof[256 + 64 * logn : 288 + 64 * logn])

    a_pt = decompress(a_b)
    s_pt = decompress(s_b)
    t1 = decompress(t1_b)
    t2 = decompress(t2_b)
    comm_pts = [decompress(cb) for cb in commitments]
    l_pts = [decompress(b) for b in l_b]
    r_pts = [decompress(b) for b in r_b]
    gens_g, gens_h = generators(n)

    t = transcript
    t.append_message(b"dom-sep", b"range-proof")
    t.append_u64(b"n", nm)
    validate_and_append_point(t, b"A", a_b)
    validate_and_append_point(t, b"S", s_b)
    y = challenge_scalar(t, b"y")
    z = challenge_scalar(t, b"z")
    validate_and_append_point(t, b"T_1", t1_b)
    validate_and_append_point(t, b"T_2", t2_b)
    x = challenge_scalar(t, b"x")
    t.append_message(b"t_x", proof[128:160])
    t.append_message(b"t_x_blinding", proof[160:192])
    t.append_message(b"e_blinding", proof[192:224])
    w = challenge_scalar(t, b"w")
    c = challenge_scalar(t, b"c")
    t.append_message(b"dom-sep", b"inner-product")
    t.append_u64(b"n", nm)
    u = []
    for i in range(logn):
        validate_and_append_point(t, b"L", l_b[i])
        validate_and_append_point(t, b"R", r_b[i])
        u.append(challenge_scalar(t, b"u"))

    y_inv = pow(y, L - 2, L)
    u_inv = [pow(ui, L - 2, L) for ui in u]

    # s_i: s[0] = prod(u_inv); s[i] = s[i - 2^k] * u[logn-1-k]^2
    s = [0] * n
    s[0] = 1
    for ui in u_inv:
        s[0] = s[0] * ui % L
    u_sq = [ui * ui % L for ui in u]
    for k in range(logn):
        powk = 1 << k
        for j in range(powk):
            s[powk + j] = s[j] * u_sq[logn - 1 - k] % L

    zz = z * z % L
    scalars: list[int] = []
    points: list = []
    # G: w (t_x - a b) + c (delta - t_x)
    scalars.append((w * (tx - a_sc * b_sc) + c * (
        _delta(nm, y, z, bit_lengths) - tx)) % L)
    points.append(G)
    # H: -(eb + c txb)
    scalars.append((L - (eb + c * txb) % L) % L)
    points.append(H)
    # S, T_1, T_2
    scalars += [x, c * x % L, c * x % L * x % L]
    points += [s_pt, t1, t2]
    # commitments: c z^2, c z^3, ...
    cz = zz * c % L
    for pt in comm_pts:
        scalars.append(cz)
        points.append(pt)
        cz = cz * z % L
    # L_i: u_i^2;  R_i: u_i^-2
    for i in range(logn):
        scalars.append(u_sq[i])
        points.append(l_pts[i])
    for i in range(logn):
        scalars.append(u_inv[i] * u_inv[i] % L)
        points.append(r_pts[i])
    # generators_H[i]: (z^{2+m} 2^j - b s_{n-1-i}) * y^-i + z
    # (position i sits at bit j of commitment m)
    exp_z = zz
    z_and_2 = exp_z
    j = 0
    m = 0
    yi = 1
    for i in range(n):
        if j == bit_lengths[m]:
            j = 0
            m += 1
            exp_z = exp_z * z % L
            z_and_2 = exp_z
        if j != 0:
            z_and_2 = z_and_2 * 2 % L
        scalars.append(
            (((z_and_2 - b_sc * s[n - 1 - i]) % L) * yi + z) % L
        )
        points.append(gens_h[i])
        yi = yi * y_inv % L
        j += 1
    # generators_G: -a s_i - z
    for i in range(n):
        scalars.append((L - (a_sc * s[i] + z) % L) % L)
        points.append(gens_g[i])

    res = msm(scalars, points)
    if not ri.eq(res, point_neg(a_pt)):
        raise ZkError("range proof verification failed")


# -- prover (client side / tests) ---------------------------------------------


def _rand_scalar(seed: bytes, tag: bytes) -> int:
    return int.from_bytes(
        hashlib.sha512(b"rp:" + tag + b":" + seed).digest(), "little") % L


def prove_range(
    amounts: list[int],
    blindings: list[int],
    bit_lengths: list[int],
    transcript: Transcript,
    seed: bytes,
) -> bytes:
    """Aggregated bulletproof over commitments C_j = v_j G + gamma_j H."""
    nm = sum(bit_lengths)
    logn = nm.bit_length() - 1
    if 1 << logn != nm:
        raise ZkError("total bits must be a power of two")
    n = nm
    gens_g, gens_h = generators(n)

    # bit vectors
    a_l: list[int] = []
    for v, b in zip(amounts, bit_lengths):
        if not 0 <= v < (1 << b):
            raise ZkError("amount out of range")
        a_l += [(v >> k) & 1 for k in range(b)]
    a_r = [(x - 1) % L for x in a_l]

    alpha = _rand_scalar(seed, b"alpha")
    rho = _rand_scalar(seed, b"rho")
    s_l = [_rand_scalar(seed, b"sl%d" % i) for i in range(n)]
    s_r = [_rand_scalar(seed, b"sr%d" % i) for i in range(n)]

    def vec_commit(blind, lvec, rvec):
        return msm([blind] + lvec + rvec, [H] + gens_g + gens_h)

    a_pt = vec_commit(alpha, a_l, a_r)
    s_pt = vec_commit(rho, s_l, s_r)
    a_b, s_b = ri.encode(a_pt), ri.encode(s_pt)

    t = transcript
    t.append_message(b"dom-sep", b"range-proof")
    t.append_u64(b"n", nm)
    validate_and_append_point(t, b"A", a_b)
    validate_and_append_point(t, b"S", s_b)
    y = challenge_scalar(t, b"y")
    z = challenge_scalar(t, b"z")
    zz = z * z % L

    # l(X) = (a_L - z) + s_L X ; r(X) = y^i (a_R + z + s_R X) + zeta_i
    # zeta_i = z^{2+j} 2^k at position i = (commitment j, bit k)
    zeta = []
    exp_z = zz
    for j, b in enumerate(bit_lengths):
        for k in range(b):
            zeta.append(exp_z * pow(2, k, L) % L)
        exp_z = exp_z * z % L
    yv = [pow(y, i, L) for i in range(n)]
    l0 = [(a_l[i] - z) % L for i in range(n)]
    l1 = s_l
    r0 = [(yv[i] * ((a_r[i] + z) % L) + zeta[i]) % L for i in range(n)]
    r1 = [yv[i] * s_r[i] % L for i in range(n)]

    t0 = sum(l0[i] * r0[i] for i in range(n)) % L
    t1_sc = (sum(l0[i] * r1[i] for i in range(n))
             + sum(l1[i] * r0[i] for i in range(n))) % L
    t2_sc = sum(l1[i] * r1[i] for i in range(n)) % L

    tau1 = _rand_scalar(seed, b"tau1")
    tau2 = _rand_scalar(seed, b"tau2")
    t1_pt = point_add(point_mul(t1_sc, G), point_mul(tau1, H))
    t2_pt = point_add(point_mul(t2_sc, G), point_mul(tau2, H))
    t1_b, t2_b = ri.encode(t1_pt), ri.encode(t2_pt)
    validate_and_append_point(t, b"T_1", t1_b)
    validate_and_append_point(t, b"T_2", t2_b)
    x = challenge_scalar(t, b"x")

    l_vec = [(l0[i] + l1[i] * x) % L for i in range(n)]
    r_vec = [(r0[i] + r1[i] * x) % L for i in range(n)]
    t_x = (t0 + t1_sc * x + t2_sc * x * x) % L
    tau_x = (tau2 * x * x + tau1 * x) % L
    exp_z = zz
    for gamma in blindings:
        tau_x = (tau_x + exp_z * gamma) % L
        exp_z = exp_z * z % L
    mu = (alpha + rho * x) % L

    t.append_message(b"t_x", t_x.to_bytes(32, "little"))
    t.append_message(b"t_x_blinding", tau_x.to_bytes(32, "little"))
    t.append_message(b"e_blinding", mu.to_bytes(32, "little"))
    w = challenge_scalar(t, b"w")
    _c = challenge_scalar(t, b"c")  # verifier-side combiner

    # inner-product argument over G_i and H'_i = y^-i H_i with Q = w G
    t.append_message(b"dom-sep", b"inner-product")
    t.append_u64(b"n", nm)
    y_inv = pow(y, L - 2, L)
    hp = [point_mul(pow(y_inv, i, L), gens_h[i]) for i in range(n)]
    gv = list(gens_g)
    av = list(l_vec)
    bv = list(r_vec)
    q = point_mul(w, G)
    lr_out = b""
    while len(av) > 1:
        half = len(av) // 2
        a_lo, a_hi = av[:half], av[half:]
        b_lo, b_hi = bv[:half], bv[half:]
        g_lo, g_hi = gv[:half], gv[half:]
        h_lo, h_hi = hp[:half], hp[half:]
        c_l = sum(a_lo[i] * b_hi[i] for i in range(half)) % L
        c_r = sum(a_hi[i] * b_lo[i] for i in range(half)) % L
        l_pt = point_add(msm(a_lo + b_hi, g_hi + h_lo),
                         point_mul(c_l, q))
        r_pt = point_add(msm(a_hi + b_lo, g_lo + h_hi),
                         point_mul(c_r, q))
        l_b, r_b = ri.encode(l_pt), ri.encode(r_pt)
        validate_and_append_point(t, b"L", l_b)
        validate_and_append_point(t, b"R", r_b)
        ui = challenge_scalar(t, b"u")
        ui_inv = pow(ui, L - 2, L)
        lr_out += l_b + r_b
        av = [(a_lo[i] * ui + a_hi[i] * ui_inv) % L for i in range(half)]
        bv = [(b_lo[i] * ui_inv + b_hi[i] * ui) % L for i in range(half)]
        gv = [point_add(point_mul(ui_inv, g_lo[i]), point_mul(ui, g_hi[i]))
              for i in range(half)]
        hp = [point_add(point_mul(ui, h_lo[i]), point_mul(ui_inv, h_hi[i]))
              for i in range(half)]

    return (
        a_b + s_b + t1_b + t2_b
        + t_x.to_bytes(32, "little")
        + tau_x.to_bytes(32, "little")
        + mu.to_bytes(32, "little")
        + lr_out
        + av[0].to_bytes(32, "little")
        + bv[0].to_bytes(32, "little")
    )
