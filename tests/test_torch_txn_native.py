"""The port's native txn parser (protocol/txn_native.py over
native/fd_txn_parse.cpp) against the port's Python parser and the JAX
package's native parser: on the valid corpus, the rejections and a mutation
fuzz, `txn_parse_packed` accepts and rejects alike and gives the bytes of
`ft.txn_pack(ft.txn_parse(p))` and of JAX's `txn_parse_packed`.
`BurstParser` gives the per-packet descriptors over a burst.  The verify
stage's intake runs on it: frames equal the JAX package's, with neither
the Python parser nor txn_pack called.  g++ builds the library on first
use (utils/hostbuild.py)."""

import ctypes

import numpy as np
import pytest

from firedancer_tpu.protocol import txn_native as jn
from firedancer_tpu.runtime import verify as jverify
from firedancer_tpu_torch.models.leader import build_verify_pipeline
from firedancer_tpu_torch.models.workload import verify_stream
from firedancer_tpu_torch.protocol import txn as ft
from firedancer_tpu_torch.protocol import txn_native as tn
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from tests.test_txn import keypair, simple_legacy
from tests.test_txn_native import _v0_with_luts


def assert_agree(payload: bytes) -> bool:
    """The three parsers agree on `payload`; True if it parsed."""
    py = ft.txn_parse(payload)
    packed = tn.txn_parse_packed(payload)
    assert (py is None) == (packed is None), payload.hex()
    assert packed == jn.txn_parse_packed(payload)
    if py is None:
        assert tn.txn_parse_native(payload) is None
        return False
    assert packed == ft.txn_pack(py)
    assert len(packed) == ft.txn_packed_sz(packed[16], packed[13])
    assert tn.txn_parse_native(payload) == py
    return True


def _corpus() -> list[bytes]:
    return ([simple_legacy(n_extra_accts=k, n_instr=j, data=b"d" * (k + 1))
             for k in (1, 3) for j in (1, 4)]
            + gen_transfer_pool(8, seed=b"natcorp")
            + [_v0_with_luts()]
            + [ft.vote_txn(keypair(b"nv")[0], b"V" * 32, 7, bytes(32))])


def test_valid_corpus_agrees():
    for p in _corpus():
        assert assert_agree(p)


def _bad_cases() -> list[bytes]:
    base = simple_legacy()
    cases = [
        b"",
        b"\x00",
        base[:-1],                  # truncated tail
        base + b"\x00",             # trailing byte
        b"\x00" + base[1:],         # sig_cnt 0
        base[:200],                 # truncated mid-message
        bytes([200]) + base[1:],    # sig_cnt > 127
    ]
    b2 = bytearray(base)
    b2[65] = 9  # header count mismatch
    cases.append(bytes(b2))
    b3 = bytearray(base)
    b3[65] = 0x81  # versioned, version 1
    cases.append(bytes(b3))
    return cases


@pytest.mark.parametrize("i", range(9))
def test_rejections_agree(i):
    p = _bad_cases()[i]
    assert not assert_agree(p)


@pytest.mark.parametrize("seed", ["legacy", "v0"])
def test_mutation_fuzz_agrees(seed):
    rng = np.random.default_rng(0xF12E)
    base = simple_legacy() if seed == "legacy" else _v0_with_luts()
    n_ok = 0
    for _ in range(400):
        m = bytearray(base)
        for _ in range(rng.integers(1, 4)):
            op = rng.integers(0, 3)
            if op == 0 and len(m) > 1:
                m[rng.integers(0, len(m))] = rng.integers(0, 256)
            elif op == 1 and len(m) > 2:
                del m[rng.integers(0, len(m))]
            else:
                m.insert(rng.integers(0, len(m) + 1), rng.integers(0, 256))
        n_ok += assert_agree(bytes(m))
    assert 0 < n_ok < 400


def test_noise_agrees():
    rng = np.random.default_rng(0xF12F)
    for n in (0, 1, 50, 300, 1232, 1233):
        for _ in range(30):
            assert_agree(rng.bytes(n))


def _burst():
    rng = np.random.default_rng(5)
    payloads = _corpus() + _bad_cases()
    for p in _corpus()[:6]:
        b = bytearray(p)
        b[int(rng.integers(0, len(b)))] ^= 0x5A
        payloads.append(bytes(b))
    order = rng.permutation(len(payloads))
    payloads = [payloads[i] for i in order]
    buf = bytearray(b"\xee" * 7)  # payloads need not start at 0
    rows = []
    for p in payloads:
        rows.append((0, 0, len(buf), len(p)))
        buf += p
    return payloads, bytes(buf), rows


def test_burst_parser_equals_the_per_packet_parse():
    payloads, buf, rows = _burst()
    want = [tn.txn_parse_packed(p) for p in payloads]
    assert any(w is None for w in want) and any(w is not None for w in want)
    bp = tn.BurstParser(max_rows=4)  # the burst outgrows the row tables
    assert bp.parse(buf, rows) == want
    assert bp._max >= len(rows)
    assert bp.parse(buf, rows[:3]) == want[:3]  # the buffers are reused
    assert bp.parse(buf, []) == []


def test_burst_parser_grows_its_arena():
    payloads, buf, rows = _burst()
    bp = tn.BurstParser(max_rows=len(rows))
    bp._cap = 32  # too small for the burst's descriptors: the call says -2
    bp._out = ctypes.create_string_buffer(32)
    assert bp.parse(buf, rows) == [tn.txn_parse_packed(p) for p in payloads]
    assert bp._cap > 32


def test_verify_intake_runs_on_the_native_parser(monkeypatch):
    """The verify stage reads sigs, message and signers off the native
    descriptor and forwards it as is: with the Python parser and txn_pack
    unavailable, the frames still equal what the JAX package's
    encode_verified gives."""
    stream = verify_stream(12, n_multisig=2, n_corrupt=2, n_resend=2)

    def boom(*_a, **_k):
        raise AssertionError("the verify stage called the Python parser")

    monkeypatch.setattr(ft, "txn_parse", boom)
    monkeypatch.setattr(ft, "txn_pack", boom)
    pipe = build_verify_pipeline(stream.stream, device="cpu", batch=8, max_msg_len=256)
    pipe.run()
    monkeypatch.undo()
    frames = [p for p, _ in pipe.sink.frames]
    assert frames == stream.expect_sunk
    honest = [jverify.decode_verified(f)[0] for f in frames]
    assert frames == [jverify.encode_verified_packed(p, jn.txn_parse_packed(p)) for p in honest]
    rep = pipe.report()
    assert rep["verify"]["parse_fail"] == stream.expect["parse_fail"]
    assert rep["verify"]["txn_verified"] == stream.expect["txn_verified"]
