"""The port's ed25519 and secp256k1 precompiles (flamenco/precompiles.py)
and its secp256k1 (ops/secp256k1.py) against the JAX package's, exactly:

  - the two precompile cases of tests/test_nonce_precompiles.py on both
    packages (an ed25519 entry good, with a flipped signature byte and
    truncated; a secp256k1 entry good and with a perturbed address);
  - the cases of tests/test_secp256k1.py on the port, beside the JAX
    module's answers (the curve constants, sign and recover round trips,
    low s, invalid input, a tampered message, the Ethereum address);
  - seeded scenarios of both programs with the malformed, out-of-range,
    cross-instruction and multi-entry cases through both executors: the
    same outcome and CU;
  - precompile txns through execute_block, entries reaching into another
    instruction's data among them: the same statuses, fees and bank hash.

The JAX secp256k1 multiplies in affine coordinates, a field inversion a
step, so its side sees a handful of signatures.
"""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.flamenco import executor as jex
from firedancer_tpu.flamenco import precompiles as jpc
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu.ops import secp256k1 as jsk
from firedancer_tpu_torch.flamenco import executor as tex
from firedancer_tpu_torch.flamenco import precompiles as tpc
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.funk import Funk as TFunk
from firedancer_tpu_torch.ops import secp256k1 as sk
from firedancer_tpu_torch.ops.keccak256 import keccak256_host
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import txn as ft

PKGS = {
    "jax": SimpleNamespace(ex=jex, pc=jpc, rt=jrt, Funk=JFunk, kw={}),
    "port": SimpleNamespace(ex=tex, pc=tpc, rt=trt, Funk=TFunk, kw={"device": "cpu"}),
}


def _secret(name):
    return hashlib.sha256(b"np:" + name).digest()


def _run_instr(p, program_id, data, instr_datas=None):
    """One precompile instruction through the package's executor: the
    outcome's class and the CU charged."""
    ctx = p.ex.TxnCtx(accounts=[], signer=[], writable=[],
                      instr_datas=instr_datas if instr_datas is not None else [data])
    try:
        p.ex.Executor().execute_instr(ctx, program_id, [], data)
        outcome = "ok"
    except Exception as e:  # the outcome's class is what both packages must share
        outcome = type(e).__name__
    return outcome, ctx.cu_used


def _both(program_id, data, instr_datas=None):
    t = _run_instr(PKGS["port"], program_id, data, instr_datas)
    assert t == _run_instr(PKGS["jax"], program_id, data, instr_datas)
    return t[0]


SECP_D = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF1234567890ABCDE


def _secp_entry(msg=b"eth-style message", d=SECP_D):
    x, y = sk.pubkey_of(d)
    eth = keccak256_host(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[-20:]
    sig, rec = sk.sign(d, keccak256_host(msg))
    return sig, rec, eth, msg


# -- tests/test_nonce_precompiles.py's precompile cases on both packages ----------------------


def test_ed25519_precompile_ok_and_bad_like_jax():
    secret = _secret(b"ed")
    pk = ref.public_key(secret)
    msg = b"the precompiled message"
    data = tpc.ed25519_entry_data(ref.sign(secret, msg), pk, msg)
    head = 2 + 14
    assert _both(tpc.ED25519_PROGRAM, data) == "ok"
    bad = bytearray(data)
    bad[head + 5] ^= 1
    assert _both(tpc.ED25519_PROGRAM, bytes(bad)) == "AcctError"
    assert _both(tpc.ED25519_PROGRAM, data[: head + 40]) == "AcctError"


def test_secp256k1_precompile_roundtrip_like_jax():
    sig, rec, eth, msg = _secp_entry()
    data = tpc.secp256k1_entry_data(sig, rec, eth, msg)
    assert data[1:12] == jpc._SECP_ENTRY.pack(12, 0xFF, 12 + 65, 0xFF, 12 + 85, len(msg), 0xFF)
    assert _both(tpc.SECP256K1_PROGRAM, data) == "ok"
    wrong = bytearray(data)
    wrong[12 + 65] ^= 1
    assert _both(tpc.SECP256K1_PROGRAM, bytes(wrong)) == "AcctError"


def test_program_ids_and_layouts_equal_jax():
    assert (tpc.ED25519_PROGRAM, tpc.SECP256K1_PROGRAM) == (jpc.ED25519_PROGRAM,
                                                            jpc.SECP256K1_PROGRAM)
    assert (tpc.ED_ENTRY.format, tpc.SECP_ENTRY.format) == (jpc._ED_ENTRY.format,
                                                            jpc._SECP_ENTRY.format)
    assert (tpc.SELF_IX16, tpc.SELF_IX8) == (jpc._SELF_IX16, jpc._SELF_IX8)


# -- tests/test_secp256k1.py's cases beside the JAX module ------------------------------------


def test_generator_on_curve_and_order():
    assert (sk.P, sk.N, sk.G) == (jsk.P, jsk.N, jsk.G)
    assert (sk.GY * sk.GY - (sk.GX**3 + 7)) % sk.P == 0
    assert sk._mul(sk.N, sk.G) is None
    assert sk._mul(2, sk.G) == jsk._mul(2, jsk.G)
    assert sk._mul(2, sk.G)[0] == \
        0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5
    assert sk._mul(sk.N + 1, sk.G) == sk.G and sk._mul(0, sk.G) is None
    assert sk._mul(3, sk.G) == jsk._add(jsk.G, jsk._mul(2, jsk.G))


def test_sign_recover_roundtrip_equals_jax():
    for i in range(1, 4):
        secret = int.from_bytes(hashlib.sha256(b"k%d" % i).digest(), "big") % sk.N
        pub = sk.pubkey_of(secret)
        assert pub == jsk.pubkey_of(secret)
        pub64 = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
        h = hashlib.sha256(b"msg%d" % i).digest()
        sig, rec = sk.sign(secret, h)
        assert (sig, rec) == jsk.sign(secret, h)
        assert sk.recover(h, rec, sig) == jsk.recover(h, rec, sig) == pub64
        assert sk.verify(h, sig, pub64)
        try:
            assert sk.recover(h, rec ^ 1, sig) != pub64
        except sk.RecoverError:
            pass


def test_low_s_canonical():
    h = hashlib.sha256(b"low-s").digest()
    sig, _ = sk.sign(12345, h)
    assert int.from_bytes(sig[32:], "big") <= sk.N // 2
    assert (sig, _) == jsk.sign(12345, h)


def test_recover_rejects_invalid_like_jax():
    h = hashlib.sha256(b"x").digest()
    cases = [(h, 5, b"\x01" * 64), (h, 0, b"\x00" * 64), (h[:-1], 0, b"\x01" * 64),
             (h, 0, sk.N.to_bytes(32, "big") + (1).to_bytes(32, "big")),
             (h, 2, (sk.P - sk.N + 1).to_bytes(32, "big") + (1).to_bytes(32, "big")),
             (h, 0, (5).to_bytes(32, "big") + (1).to_bytes(32, "big"))]
    for args in cases:
        got = []
        for pkg in (sk, jsk):
            try:
                got.append(pkg.recover(*args))
            except pkg.RecoverError as e:
                got.append(str(e))
        assert got[0] == got[1], args
    with pytest.raises(sk.RecoverError):
        sk.recover(h, 5, b"\x01" * 64)
    with pytest.raises(sk.RecoverError):
        sk.recover(h, 0, b"\x00" * 64)
    with pytest.raises(ValueError):
        sk.pubkey_of(0)


def test_tampered_message_recovers_different_key():
    pub = sk.pubkey_of(999)
    pub64 = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    sig, rec = sk.sign(999, hashlib.sha256(b"honest").digest())
    h2 = hashlib.sha256(b"forged").digest()
    try:
        assert sk.recover(h2, rec, sig) != pub64
    except sk.RecoverError:
        pass
    assert not sk.verify(h2, sig, pub64)


def test_eth_address():
    pub = sk.pubkey_of(1)
    pub64 = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    assert sk.eth_address(pub64).hex() == "7e5f4552091a69125d5dfcb7b8c2659029395bdf"
    assert sk.eth_address(pub64) == jsk.eth_address(pub64)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_sign_and_recover_equal_jax(seed):
    rng = np.random.default_rng(seed)
    d = int.from_bytes(rng.bytes(32), "big") % sk.N
    h = rng.bytes(32)
    sig, rec = sk.sign(d, h)
    assert (sig, rec) == jsk.sign(d, h)
    assert sk.recover(h, rec, sig) == jsk.recover(h, rec, sig)
    junk = rng.bytes(64)
    for r in range(4):
        got = []
        for pkg in (sk, jsk):
            try:
                got.append(pkg.recover(h, r, junk))
            except pkg.RecoverError as e:
                got.append(str(e))
        assert got[0] == got[1]


# -- both programs through both executors ---------------------------------------------------

ED_SECRET = _secret(b"ed-scen")
ED_PK = ref.public_key(ED_SECRET)
ED_MSG = b"a message held in another instruction"
ED_SIG = ref.sign(ED_SECRET, ED_MSG)
SECP = _secp_entry(b"secp scenario message", d=SECP_D)


def _ed(entries, head_count=None):
    """An ed25519 offset table over `entries` of (sig_off, sig_ix, pk_off,
    pk_ix, msg_off, msg_sz, msg_ix), then `tail` bytes."""
    count = len(entries) if head_count is None else head_count
    return bytes([count, 0]) + b"".join(tpc.ED_ENTRY.pack(*e) for e in entries)


OTHER_IX = ED_SIG + ED_PK + ED_MSG  # instruction 1's data: sig | pk | message
OWN = tpc.ed25519_entry_data(ED_SIG, ED_PK, ED_MSG)
TWO_HEAD = 2 + 2 * 14
TWO = _ed([(TWO_HEAD, 0xFFFF, TWO_HEAD + 64, 0xFFFF, TWO_HEAD + 96, len(ED_MSG), 0xFFFF)] * 2) \
    + ED_SIG + ED_PK + ED_MSG
SECP_OWN = tpc.secp256k1_entry_data(SECP[0], SECP[1], SECP[2], SECP[3])
# name: (program ("ed" or "secp"), data, the txn's other instruction data, outcome)
PC_SCENARIOS = {
    "ed_own_data": ("ed", OWN, None, "ok"),
    "ed_zero_entries": ("ed", b"\x00\x00", None, "ok"),
    "ed_two_entries": ("ed", TWO, None, "ok"),
    "ed_second_entry_bad": ("ed", TWO[:-1] + bytes([TWO[-1] ^ 1]), None, "AcctError"),
    "ed_across_instructions": ("ed", _ed([(0, 1, 64, 1, 96, len(ED_MSG), 1)]), OTHER_IX, "ok"),
    "ed_across_bad_message": ("ed", _ed([(0, 1, 64, 1, 96, len(ED_MSG) - 1, 1)]), OTHER_IX,
                              "AcctError"),
    "ed_instruction_out_of_range": ("ed", _ed([(0, 5, 64, 1, 96, 4, 1)]), OTHER_IX,
                                    "AcctError"),
    "ed_offset_out_of_range": ("ed", _ed([(0, 1, 64, 1, 96, len(ED_MSG) + 1, 1)]), OTHER_IX,
                               "AcctError"),
    "ed_short": ("ed", b"\x01", None, "AcctError"),
    "ed_truncated_table": ("ed", _ed([], head_count=2), None, "AcctError"),
    "ed_wrong_key": ("ed", tpc.ed25519_entry_data(ED_SIG, ref.public_key(_secret(b"x")), ED_MSG),
                     None, "AcctError"),
    "ed_small_order_key": ("ed", tpc.ed25519_entry_data(ED_SIG, bytes(32), ED_MSG), None,
                           "AcctError"),
    "secp_own_data": ("secp", SECP_OWN, None, "ok"),
    "secp_zero_entries": ("secp", b"\x00", None, "ok"),
    "secp_bad_recovery_id": ("secp", SECP_OWN[:12 + 64] + b"\x07" + SECP_OWN[12 + 65:], None,
                             "AcctError"),
    "secp_wrong_message": ("secp", SECP_OWN[:-1] + bytes([SECP_OWN[-1] ^ 1]), None, "AcctError"),
    "secp_across_instructions": ("secp", bytes([1]) + tpc.SECP_ENTRY.pack(
        0, 1, 65, 1, 85, len(SECP[3]), 1), SECP[0] + bytes([SECP[1]]) + SECP[2] + SECP[3], "ok"),
    "secp_instruction_out_of_range": ("secp", bytes([1]) + tpc.SECP_ENTRY.pack(
        0, 9, 65, 1, 85, 4, 1), b"\x00" * 120, "AcctError"),
    "secp_short": ("secp", b"", None, "AcctError"),
    "secp_truncated_table": ("secp", b"\x02" + bytes(11), None, "AcctError"),
}


@pytest.mark.parametrize("name", sorted(PC_SCENARIOS))
def test_precompile_instruction_equals_jax(name):
    prog, data, other, want = PC_SCENARIOS[name]
    pid = tpc.ED25519_PROGRAM if prog == "ed" else tpc.SECP256K1_PROGRAM
    instr_datas = [data] + ([other] if other is not None else [])
    assert _both(pid, data, instr_datas) == want


# -- precompile txns through execute_block ----------------------------------------------------


def _pc_txn(payer_secret, program, datas, bh):
    pub = ref.public_key(payer_secret)
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=[pub, program], recent_blockhash=bh,
        instrs=[ft.InstrSpec(program_id=1, accounts=b"", data=d) for d in datas])
    return ft.txn_assemble([ref.sign(payer_secret, msg)], msg)


def test_precompile_block_equals_jax():
    payer = _secret(b"pc-payer")
    bh = hashlib.sha256(b"pc-bh").digest()
    # instruction 1 is a zero-entry precompile call that holds instruction
    # 0's signature, key and message
    across = _ed([(2, 1, 66, 1, 98, len(ED_MSG), 1)])
    txns = [
        _pc_txn(payer, tpc.ED25519_PROGRAM, [OWN], bh),
        _pc_txn(payer, tpc.ED25519_PROGRAM, [across, b"\x00\x00" + OTHER_IX], bh),
        _pc_txn(payer, tpc.ED25519_PROGRAM, [TWO[:-1] + bytes([TWO[-1] ^ 1])], bh),
        _pc_txn(payer, tpc.SECP256K1_PROGRAM, [SECP_OWN], bh),
        _pc_txn(payer, tpc.SECP256K1_PROGRAM, [SECP_OWN[:-1] + bytes([SECP_OWN[-1] ^ 1])], bh),
        _pc_txn(payer, tpc.ED25519_PROGRAM, [b"\x01"], bh),
    ]
    out = {}
    for name, p in PKGS.items():
        funk = p.Funk()
        funk.rec_insert(None, ref.public_key(payer), p.rt.acct_build(10**9))
        res = p.rt.execute_block(funk, slot=7, txns=txns, **p.kw)
        out[name] = (res.bank_hash, [(r.status, r.fee) for r in res.results], res.waves,
                     funk.rec_query(res.xid, ref.public_key(payer)))
    assert out["port"] == out["jax"]
    assert [st for st, _ in out["port"][1]] == [trt.TXN_SUCCESS, trt.TXN_SUCCESS, trt.TXN_ERR_ACCT,
                                                trt.TXN_SUCCESS, trt.TXN_ERR_ACCT, trt.TXN_ERR_ACCT]
    assert all(fee == 5000 for _, fee in out["port"][1])
