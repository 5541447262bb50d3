"""The port's host side of the slice against the JAX package: benchg's pool
is byte-identical for the same seed; txn_parse / txn_pack / encode_verified
agree on the pool plus multi-sig and malformed frames; and the port's
build_verify_pipeline(device="cpu") runs end to end with exact counters and
frames equal to what the JAX package's encode_verified gives for the honest
txns (and decode with its decode_verified)."""

import contextlib
import io
import json

import numpy as np
import pytest

from firedancer_tpu.protocol import txn as jft
from firedancer_tpu.runtime import benchg as jbenchg
from firedancer_tpu.runtime import verify as jverify
from firedancer_tpu_torch import __main__ as tmain
from firedancer_tpu_torch.models.leader import build_verify_pipeline
from firedancer_tpu_torch.models.workload import verify_stream
from firedancer_tpu_torch.protocol import txn as tft
from firedancer_tpu_torch.runtime import benchg as tbenchg
from firedancer_tpu_torch.runtime import verify as tverify


@pytest.fixture(scope="module")
def stream():
    return verify_stream(20, n_multisig=3, n_corrupt=3, n_resend=3)


@pytest.mark.parametrize("seed,n_payers", [(b"benchg", 8), (b"other", 3)])
def test_gen_transfer_pool_byte_identical(seed, n_payers):
    assert tbenchg.gen_transfer_pool(24, seed=seed, n_payers=n_payers) \
        == jbenchg.gen_transfer_pool(24, seed=seed, n_payers=n_payers)
    assert tbenchg.pool_payers(seed, n_payers) == jbenchg.pool_payers(seed, n_payers)


def _frames(stream):
    rng = np.random.default_rng(41)
    frames = list(stream.stream)
    for p in stream.stream[:10]:  # byte mutations: some parse, most do not
        b = bytearray(p)
        b[int(rng.integers(0, len(b)))] ^= 0xFF
        frames.append(bytes(b))
    frames += [p[:-1] for p in stream.stream[:4]] + [b"\x00", b"\x02" * 200]
    return frames


def test_parse_pack_encode_agree_with_jax(stream):
    n_ok = 0
    for p in _frames(stream):
        t, j = tft.txn_parse(p), jft.txn_parse(p)
        assert (t is None) == (j is None)
        if t is None:
            continue
        n_ok += 1
        assert tft.txn_pack(t) == jft.txn_pack(j)
        assert tft.txn_packed_sz(len(t.instrs), len(t.addr_luts)) \
            == jft.txn_packed_sz(len(j.instrs), len(j.addr_luts))
        assert t.signatures(p) == j.signatures(p)
        assert t.signers(p) == j.signers(p)
        assert t.message(p) == j.message(p)
        assert tverify.encode_verified(p, t) == jverify.encode_verified(p, j)
        payload, desc = tverify.decode_verified(tverify.encode_verified(p, t))
        assert payload == p and tft.txn_pack(desc) == tft.txn_pack(t)
    assert n_ok > len(stream.stream) // 2


def test_compact_u16_agrees_with_jax():
    for v in (0, 1, 0x7F, 0x80, 0x3FFF, 0x4000, 0xFFFF):
        enc = tft.compact_u16_encode(v)
        assert enc == jft.compact_u16_encode(v)
        assert tft.compact_u16_decode(enc, 0) == jft.compact_u16_decode(enc, 0) == (v, len(enc))
    for bad in (b"\x80\x00", b"\xff\xff\x04", b"\x80"):
        assert tft.compact_u16_decode(bad, 0) is None
        assert jft.compact_u16_decode(bad, 0) is None


def test_verify_pipeline_cpu_end_to_end(stream):
    pipe = build_verify_pipeline(stream.stream, device="cpu", batch=16,
                                 max_msg_len=256)
    pipe.run()
    rep = pipe.report()
    e = stream.expect
    assert rep["benchg"]["txn_gen"] == len(stream.stream)
    assert rep["verify"]["txn_verified"] == e["txn_verified"]
    assert rep["verify"]["verify_fail"] == e["verify_fail"]
    assert rep["verify"]["parse_fail"] == e["parse_fail"]
    assert rep["verify"]["dedup_dup"] == e["tile_dedup_dup"]
    assert rep["dedup"]["dedup_dup"] == e["dedup_dup"]
    assert rep["sink"]["txn_sunk"] == e["sunk"]
    frames = [p for p, _ in pipe.sink.frames]
    assert frames == stream.expect_sunk
    # the JAX package's host framing gives the same bytes for the honest txns
    honest = [jverify.decode_verified(f)[0] for f in frames]
    assert frames == [jverify.encode_verified(p, jft.txn_parse(p)) for p in honest]
    assert [tag for _, tag in pipe.sink.frames] == [
        jverify.sig_tag(jft.txn_parse(p).signatures(p)[0]) for p in honest]


def test_cli_run_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain.main(["run", "--txns", "6", "--batch", "8",
                         "--max-msg-len", "256", "--cpu"])
    assert rc == 0
    out = json.loads(buf.getvalue())
    assert out["device"] == "cpu"
    assert out["stages"]["sink"]["txn_sunk"] == 6
    assert out["stages"]["verify"]["txn_verified"] == 6
