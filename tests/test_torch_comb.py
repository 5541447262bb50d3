"""The repeated-signer (comb-bank) lane of the port against the JAX package,
at small sizes and exactly (integer arithmetic, tolerance zero):

  - comb_fill_plain's tables (K7's quad schedule; carried across with
    bank_to_jax/bank_from_jax, compared on canonical limbs) and ok mask
    equal JAX comb_fill's on 4 good and 4 bad keys; every entry is
    -[m 16^j]A by Python ints;
  - verify_cached_plain equals JAX ed25519_verify_batch_cached on a 4-lane
    batch with corruptions, over a bank carried across with bank_from_jax
    and over the bank comb_fill_plain fills (other limbs, the same points);
  - bank_install_plain equals JAX bank_install, reinstall included;
  - the stage's promotion policy gives the JAX stage's answers, fill queue
    and slots on one seeded sequence of sightings, and the six cases of
    tests/test_comb_policy.py hold for the port;
  - the verify pipeline with a comb bank publishes the frames, and counts
    what, the pipeline without one does, on a small vote stream in waves;
  - vote_txn is byte-identical to the JAX package's.

One module-scoped JAX compile each of comb_fill (M = 8) and
ed25519_verify_batch_cached (B = 4, max_msg_len 64); inputs are made with
numpy from a seed and handed to both packages.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import sigverify as jsv
from firedancer_tpu.protocol import txn as jft
from firedancer_tpu.runtime.verify import VerifyStage as JaxVerifyStage
from firedancer_tpu_torch.models.leader import build_verify_pipeline
from firedancer_tpu_torch.models.workload import (
    multisig_txn,
    nonsquare_encodings,
    vote_stream,
)
from firedancer_tpu_torch.ops import convert as tcv
from firedancer_tpu_torch.ops import limbs as tl
from firedancer_tpu_torch.ops import sigverify as tsv
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import txn as tft
from firedancer_tpu_torch.runtime import verify as tverify
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from firedancer_tpu_torch.utils import kbuild

MAX_MSG_LEN = 64
P = ref.P
GOOD = [hashlib.sha256(b"comb-good%d" % i).digest() for i in range(4)]
GOOD_PUBS = [ref.public_key(s) for s in GOOD]
BAD_PUBS = [(1).to_bytes(32, "little"),                 # the identity
            (P - 1).to_bytes(32, "little"),             # order 2
            nonsquare_encodings(1)[0],                  # not a curve point
            hashlib.sha256(b"comb-maybe").digest()]     # may or may not decode


def _cols(keys):
    return np.stack([np.frombuffer(k, np.uint8) for k in keys], 1)


def _canon(port_tables: np.ndarray) -> np.ndarray:
    """Port tables with canonical limbs (through the JAX layout and back)."""
    return tcv.bank_from_jax(tcv.bank_to_jax(port_tables))


@pytest.fixture(scope="module")
def filled():
    """JAX comb_fill and comb_fill_plain on the same 8 keys."""
    pk = _cols(GOOD_PUBS + BAD_PUBS)
    jt, jok = jsv.comb_fill(jnp.asarray(pk))
    kbuild.reset_launches()
    tt, tok = tsv.comb_fill(torch.from_numpy(pk))
    assert sum(kbuild.LAUNCHES.values()) == 0  # CPU tensors: plain version
    return np.asarray(jt), np.asarray(jok), tt.numpy(), tok.numpy()


def test_comb_fill_plain_equals_jax(filled):
    jt, jok, tt, tok = filled
    assert tt.shape == (8, 64, 16, 4, 10) and tt.dtype == np.int32
    assert tok.tolist() == jok.tolist()
    assert tok.tolist()[:7] == [True] * 4 + [False] * 3
    # every column, valid or not: the same projective triples in both packages
    assert (_canon(tt) == tcv.bank_from_jax(jt)).all()
    assert (tcv.bank_to_jax(tt) == tcv.bank_to_jax(tcv.bank_from_jax(jt))).all()


@pytest.mark.parametrize("col", [0, 3])
def test_comb_entries_equal_python_ints(filled, col):
    tt = filled[2]
    na = ref.point_neg(ref.point_decompress(GOOD_PUBS[col]))
    for j, m in ((0, 0), (0, 1), (1, 15), (17, 6), (63, 9), (63, 15)):
        x, y, z, t = ref.point_mul(m * 16**j, na)
        ypx, ymx, zz, t2d = (tl.limbs_to_int(tt[col, j, m, c]) for c in range(4))
        assert ypx * z % P == (y + x) * zz % P
        assert ymx * z % P == (y - x) * zz % P
        assert t2d * z % P == 2 * ref.D * t * zz % P
        assert zz % P != 0


def test_bank_layout_round_trips(filled):
    jt = filled[0]
    port = tcv.bank_from_jax(jt)
    assert port.shape == (8, 64, 16, 4, 10) and port.dtype == np.int32
    again = tcv.bank_to_jax(port)
    assert again.dtype == np.int16 and again.shape == jt.shape
    assert (tcv.bank_from_jax(again) == port).all()


def _cached_batch():
    """4 lanes, one per good signer: honest, corrupted message, s >= L,
    small-order R."""
    rng = np.random.default_rng(7)
    msg = np.zeros((MAX_MSG_LEN, 4), np.uint8)
    ln = np.zeros((4,), np.int32)
    sig = np.zeros((64, 4), np.uint8)
    labels = []
    for i, sk in enumerate(GOOD):
        m = rng.bytes(int(rng.integers(1, MAX_MSG_LEN + 1)))
        s = ref.sign(sk, m)
        if i == 1:
            m = m[:-1] + bytes([m[-1] ^ 1])
        elif i == 2:
            s = s[:32] + (int.from_bytes(s[32:], "little") + ref.L).to_bytes(32, "little")
        elif i == 3:
            s = BAD_PUBS[1] + s[32:]
        msg[: len(m), i] = np.frombuffer(m, np.uint8)
        ln[i] = len(m)
        sig[:, i] = np.frombuffer(s, np.uint8)
        labels.append(ref.verify(m, s, GOOD_PUBS[i]))
    return msg, ln, sig, _cols(GOOD_PUBS), labels


def test_verify_cached_plain_equals_jax(filled):
    jt = filled[0]
    slots = np.array([3, 0, 5, 2], dtype=np.int32)  # signer i's comb at slots[i]
    jbank = jsv.bank_install(jsv.bank_alloc(6), jnp.asarray(jt[..., :4]),
                             jnp.asarray(slots))
    msg, ln, sig, pk, labels = _cached_batch()
    jmask = jsv.ed25519_verify_batch_cached(
        jnp.asarray(msg), jnp.asarray(ln), jnp.asarray(sig), jnp.asarray(pk),
        jbank, jnp.asarray(slots), max_msg_len=MAX_MSG_LEN)
    bank = torch.from_numpy(tcv.bank_from_jax(np.asarray(jbank)))
    args = [torch.from_numpy(a) for a in (msg, ln, sig, pk)]
    tmask = tsv.ed25519_verify_batch_cached(*args, bank, slots, max_msg_len=MAX_MSG_LEN)
    assert tmask.tolist() == np.asarray(jmask).tolist() == labels == [True, False, False, False]
    mask, cnt = tsv.verify_cached(*args, bank, slots.tolist(), 3, max_msg_len=MAX_MSG_LEN)
    assert mask.tolist() == [True, False, False, False] and int(cnt) == 1
    # the generic lane agrees on the same lanes
    assert tsv.verify_batch(*args, 4, max_msg_len=MAX_MSG_LEN)[0].tolist() == labels


def test_verify_cached_plain_reads_the_quad_bank_as_jax_reads_its_own(filled):
    """The bank as K7 fills it (comb_fill_plain's tables: the quad
    schedule's limbs) gives verify_cached_plain JAX's mask on the same
    lanes, and the same mask as the bank carried across from JAX's tables."""
    jt, _, tt, _ = filled
    slots = np.array([1, 4, 0, 2], dtype=np.int32)
    jbank = jsv.bank_install(jsv.bank_alloc(5), jnp.asarray(jt[..., :4]),
                             jnp.asarray(slots))
    msg, ln, sig, pk, labels = _cached_batch()
    jmask = jsv.ed25519_verify_batch_cached(
        jnp.asarray(msg), jnp.asarray(ln), jnp.asarray(sig), jnp.asarray(pk),
        jbank, jnp.asarray(slots), max_msg_len=MAX_MSG_LEN)
    args = [torch.from_numpy(a) for a in (msg, ln, sig, pk)]
    qbank = tsv.bank_install(tsv.bank_alloc(5, device="cpu"),
                             torch.from_numpy(tt[:4].copy()), slots.tolist())
    jcarried = torch.from_numpy(tcv.bank_from_jax(np.asarray(jbank)))
    assert not torch.equal(qbank, jcarried)  # other limbs, the same points
    assert (_canon(qbank.numpy()) == jcarried.numpy()).all()
    for bank in (qbank, jcarried):
        mask, cnt = tsv.verify_cached(*args, bank, slots.tolist(), 4,
                                      max_msg_len=MAX_MSG_LEN)
        assert mask.tolist() == np.asarray(jmask).tolist() == labels
        assert int(cnt) == sum(labels)


def test_bank_install_plain_equals_jax(filled):
    jt, _, tt, _ = filled
    jbank = jsv.bank_install(jsv.bank_alloc(6), jnp.asarray(jt[..., :4]),
                             jnp.asarray(np.array([4, 1, 0, 5], np.int32)))
    tbank = tsv.bank_install(tsv.bank_alloc(6, device="cpu"),
                             torch.from_numpy(tt[:4].copy()), [4, 1, 0, 5])
    assert (_canon(tbank.numpy()) == tcv.bank_from_jax(np.asarray(jbank))).all()
    assert not tbank[2].any() and not tbank[3].any()
    # a reinstall overwrites its slot
    jbank = jsv.bank_install(jbank, jnp.asarray(jt[..., 3:4]),
                             jnp.asarray(np.array([1], np.int32)))
    tsv.bank_install(tbank, torch.from_numpy(tt[3:4].copy()), [1])
    assert (_canon(tbank.numpy()) == tcv.bank_from_jax(np.asarray(jbank))).all()
    assert torch.equal(tbank[1], tbank[5])
    assert torch.equal(tsv.bank_install_plain(tsv.bank_alloc(6, device="cpu"),
                                              torch.from_numpy(tt[:2].copy()),
                                              torch.tensor([5, 1])),
                       tsv.bank_install(tsv.bank_alloc(6, device="cpu"),
                                        torch.from_numpy(tt[:2].copy()), [5, 1]))


def test_comb_wrappers_refuse_bad_inputs(filled):
    tt = torch.from_numpy(filled[2][:2].copy())
    bank = tsv.bank_alloc(3, device="cpu")
    with pytest.raises(ValueError):
        tsv.bank_install(bank, tt, [1, 1])  # duplicate slots
    with pytest.raises(ValueError):
        tsv.bank_install(bank, tt, [0, 3])  # out of range
    with pytest.raises(ValueError):
        tsv.bank_install(bank.reshape(3, 64, 16, 40), tt, [0, 1])
    msg, ln, sig, pk, _ = _cached_batch()
    args = [torch.from_numpy(a) for a in (msg, ln, sig, pk)]
    with pytest.raises(ValueError):
        tsv.verify_cached(*args, bank, [0, 1, 2, 3], 4, max_msg_len=MAX_MSG_LEN)
    with pytest.raises(ValueError):
        tsv.verify_cached(*args, bank, [0, 1], 2, max_msg_len=MAX_MSG_LEN)
    with pytest.raises(ValueError):
        tsv.comb_fill(torch.zeros((31, 2), dtype=torch.uint8))
    # pad lanes are not read: their slots need not be valid
    mask, cnt = tsv.verify_cached(*args, bank, [0, 1, 99, -1], 2, max_msg_len=MAX_MSG_LEN)
    assert mask.tolist()[2:] == [False, False]


# -- the promotion policy -----------------------------------------------------------

def _pk(tag) -> bytes:
    return hashlib.sha256(b"cp:%d" % tag).digest()


def _commit_fill(stage, ok=lambda k: True):
    """_fill_bank's slot assignment without the device work: up to
    COMB_FILL_BATCH queued keys, slots popped from the free list for the
    valid ones in queue order."""
    take = min(len(stage._fill_queue), len(stage._free_slots), tverify.COMB_FILL_BATCH)
    keys = stage._fill_queue[:take]
    del stage._fill_queue[:take]
    good = [k for k in keys if ok(k)]
    for k, s in zip(good, [stage._free_slots.pop() for _ in good]):
        stage._slot_of[k] = s
        stage._seen_cnt.pop(k, None)


def test_signer_slots_policy_matches_jax():
    jv = JaxVerifyStage("v", ins=[], outs=[], comb_slots=8)
    tv = tverify.VerifyStage("v", device="cpu", comb_slots=8)
    rng = np.random.default_rng(11)
    pool = [_pk(i) for i in range(14)]
    bad = {pool[13]}
    for step in range(600):
        if step == 300:  # a burst of one-shot keys trips the spam guard
            for i in range(16 * 256 + 5):
                sig = [_pk(10_000 + i)]
                assert jv._signer_slots(sig) == tv._signer_slots(sig)
        n = 1 + int(rng.integers(0, 3))
        signers = [pool[int(i)] for i in rng.choice(len(pool), n, replace=False)]
        assert jv._signer_slots(signers) == tv._signer_slots(signers)
        assert jv._fill_queue == tv._fill_queue
        if step % 25 == 24:
            _commit_fill(jv, lambda k: k not in bad)
            _commit_fill(tv, lambda k: k not in bad)
            assert jv._slot_of == tv._slot_of
            assert jv._free_slots == tv._free_slots
    assert len(tv._slot_of) == 8 and not tv._free_slots


def test_fill_bank_assigns_the_jax_slots():
    """The port's real _fill_bank (comb_fill over exactly the keys taken,
    install of the ok columns) gives each signer the slot the JAX stage's
    slot rule gives it, and never banks a bad key."""
    jv = JaxVerifyStage("v", ins=[], outs=[], comb_slots=4)
    tv = tverify.VerifyStage("v", device="cpu", comb_slots=4)
    seq = [GOOD_PUBS[0], BAD_PUBS[2], GOOD_PUBS[1], GOOD_PUBS[0], BAD_PUBS[2],
           GOOD_PUBS[1], GOOD_PUBS[2], GOOD_PUBS[2]]
    for pk in seq:
        jv._signer_slots([pk])
        tv._signer_slots([pk])
    assert tv._fill_queue == jv._fill_queue == [GOOD_PUBS[0], BAD_PUBS[2],
                                                GOOD_PUBS[1], GOOD_PUBS[2]]
    _commit_fill(jv, lambda k: k != BAD_PUBS[2])
    tv._fill_bank()
    assert tv._slot_of == jv._slot_of == {GOOD_PUBS[0]: 3, GOOD_PUBS[1]: 2, GOOD_PUBS[2]: 1}
    assert tv._free_slots == jv._free_slots == [0]
    assert tv.metrics.get("comb_filled") == 3 and tv.metrics.get("comb_fills") == 1
    want = torch.from_numpy(_cols(GOOD_PUBS[:3]))
    tables, _ = tsv.comb_fill_plain(want)
    for i in range(3):
        assert torch.equal(tv._bank[3 - i], tables[i])
    assert not tv._bank[0].any()


def _mk(comb_slots=8, threshold=2):
    return tverify.VerifyStage("v", device="cpu", comb_slots=comb_slots,
                               promote_threshold=threshold)


def _install_queued(v):
    for p in v._fill_queue:
        v._slot_of[p] = v._free_slots.pop(0)
    v._fill_queue.clear()


def _case_hot_signers_promote_and_hit():
    v = _mk()
    hot = [_pk(i) for i in range(4)]
    for p in hot:
        assert v._signer_slots([p]) is None
        assert v._signer_slots([p]) is None
    assert set(v._fill_queue) == set(hot)
    _install_queued(v)
    for p in hot:
        slots = v._signer_slots([p])
        assert slots is not None and len(slots) == 1


def _case_one_shot_spam_does_not_promote_or_grow():
    v = _mk(comb_slots=8, threshold=2)
    for i in range(100_000):
        assert v._signer_slots([_pk(1_000_000 + i)]) is None
    assert not v._fill_queue and not v._slot_of
    assert len(v._seen_cnt) <= 16 * 256 + 1


def _case_spam_cannot_evict_established_combs():
    v = _mk(comb_slots=4, threshold=2)
    hot = [_pk(i) for i in range(4)]
    for p in hot:
        v._signer_slots([p])
        v._signer_slots([p])
    _install_queued(v)
    assert not v._free_slots
    for i in range(10_000):
        a = _pk(2_000_000 + i % 50)
        v._signer_slots([a])
        v._signer_slots([a])
    assert not v._fill_queue or all(p not in v._slot_of for p in v._fill_queue)
    for p in hot:
        assert p in v._slot_of and v._signer_slots([p]) is not None


def _case_threshold_crossing_racing_full_queue_still_promotes():
    v = _mk(comb_slots=2, threshold=2)
    for p in (_pk(10), _pk(11)):
        v._signer_slots([p])
        v._signer_slots([p])
    assert len(v._fill_queue) == 2
    late = _pk(12)
    v._signer_slots([late])
    v._signer_slots([late])
    assert late not in v._fill_queue
    _install_queued(v)
    v2 = _mk(comb_slots=4, threshold=2)
    for p in (_pk(20), _pk(21)):
        v2._signer_slots([p])
        v2._signer_slots([p])
    v2._signer_slots([late])
    v2._signer_slots([late])
    assert late in v2._fill_queue


def _case_seen_counter_flush_spares_promoted_signers():
    v = _mk(comb_slots=2, threshold=2)
    hot = _pk(30)
    v._signer_slots([hot])
    v._signer_slots([hot])
    _install_queued(v)
    for i in range(16 * 256 + 10):
        v._signer_slots([_pk(3_000_000 + i)])
    assert hot in v._slot_of and v._signer_slots([hot]) is not None


def _case_mixed_signers_fall_back_to_generic_lane():
    v = _mk(comb_slots=4, threshold=1)
    a = _pk(40)
    v._signer_slots([a])
    _install_queued(v)
    assert v._signer_slots([a]) is not None
    assert v._signer_slots([a, _pk(41)]) is None


POLICY_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_hot_signers_promote_and_hit,
    _case_one_shot_spam_does_not_promote_or_grow,
    _case_spam_cannot_evict_established_combs,
    _case_threshold_crossing_racing_full_queue_still_promotes,
    _case_seen_counter_flush_spares_promoted_signers,
    _case_mixed_signers_fall_back_to_generic_lane)}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_comb_policy_holds_for_the_port(case):
    POLICY_CASES[case]()


# -- the stage and the pipeline ----------------------------------------------------

@pytest.fixture(scope="module")
def votes():
    return vote_stream(3, 3, seed=b"tcomb", n_transfers=4, n_payers=1)


def _drive(vs, comb_slots):
    pipe = build_verify_pipeline(vs.stream, device="cpu", batch=8,
                                 max_msg_len=256, comb_slots=comb_slots)
    kbuild.reset_launches()
    pipe.run_waves([vs.wave1, len(vs.stream)])
    assert sum(kbuild.LAUNCHES.values()) == 0
    return pipe.report(), [p for p, _ in pipe.sink.frames]


def test_comb_pipeline_equals_the_generic_one(votes):
    vs = votes
    rep0, frames0 = _drive(vs, 0)
    rep, frames = _drive(vs, 4)
    e = vs.expect
    for r in (rep0, rep):
        assert r["verify"]["txn_verified"] == e["txn_verified"]
        assert r["verify"]["verify_fail"] == e["verify_fail"]
        assert r["verify"].get("parse_fail", 0) == e["parse_fail"]
        assert r["verify"].get("dedup_dup", 0) == e["tile_dedup_dup"]
        assert r["dedup"]["dedup_dup"] == e["dedup_dup"]
        assert r["sink"]["txn_sunk"] == e["sunk"]
    assert sorted(frames) == sorted(frames0) == sorted(vs.expect_sunk)
    assert frames0 == vs.expect_sunk  # one lane keeps the stream's order
    v = rep["verify"]
    assert v["comb_elems"] == e["comb_elems"] > 0
    assert v["comb_filled"] == e["comb_filled"] == 4
    assert v["comb_batches"] >= 1 and v["comb_installs"] >= 1
    assert v["comb_fills"] >= v["comb_installs"]
    assert "comb_elems" not in rep0["verify"] and "comb_fills" not in rep0["verify"]


def test_batch_overflow_opens_the_next_batch():
    """A two-signature txn that does not fit the open batch starts the next
    one, on either lane, and its bad second signature fails it.  (The JAX
    stage appends it to the batch it has just sealed: ROADMAP C.)"""
    pool = gen_transfer_pool(6, seed=b"ovf", n_payers=1)
    keys = [hashlib.sha256(b"ovf-m%d" % k).digest() for k in range(2)]
    pubs = [ref.public_key(k) for k in keys]
    bh = hashlib.sha256(b"ovf-bh").digest()
    bad = multisig_txn(keys, pubs, bh, 7, bad_sig=1)
    good = multisig_txn(keys, pubs, bh, 8)
    for comb_slots in (0, 4):
        v = tverify.VerifyStage("v", device="cpu", batch=4, max_msg_len=256,
                                batch_deadline_s=3600.0, comb_slots=comb_slots,
                                promote_threshold=1)
        if comb_slots:
            for pk in [ref.public_key(hashlib.sha256(b"ovfpayer0").digest())] + pubs:
                v._signer_slots([pk])
            v._fill_bank()
            assert len(v._slot_of) == 3
        for p in pool[:3] + [bad] + pool[3:5] + [good]:
            v._accumulate(v._intake(p), p, 0)
        v.flush()
        assert v.metrics.get("batches") == 3 and v.metrics.get("batch_elems") == 9
        assert v.metrics.get("txn_verified") == 6 and v.metrics.get("verify_fail") == 1
        assert v.metrics.get("comb_elems") == (9 if comb_slots else 0)


def test_vote_txn_byte_identical_to_jax():
    bh = hashlib.sha256(b"vt-bh").digest()
    for i, slot in enumerate((0, 1, 2**40 + 3)):
        sk = hashlib.sha256(b"vt%d" % i).digest()
        acct = hashlib.sha256(b"vt-acct%d" % i).digest()
        assert tft.vote_txn(sk, acct, slot, bh) == jft.vote_txn(sk, acct, slot, bh)
    h = hashlib.sha256(b"vt-hash").digest()
    assert tft.vote_txn(sk, acct, 9, bh, voter_pubkey=bytes(32), bank_hash=h) \
        == jft.vote_txn(sk, acct, 9, bh, voter_pubkey=bytes(32), bank_hash=h)
    assert tft.VOTE_PROGRAM == jft.VOTE_PROGRAM
