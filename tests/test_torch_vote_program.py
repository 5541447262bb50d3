"""The port's vote program (flamenco/vote_program.py over agave_state.py and
the vote codecs of types.py) against the JAX package's, exactly:

  - every case of tests/test_vote_program.py (lockout doubling, expiry,
    the root at 31 with its credit, credit grading, SlotHashes checks,
    voter rotation, tower-sync validation, timestamps, epoch credits) run
    on the same VoteState through both packages: the same assertions
    hold and the final states encode to the same bytes;
  - vote_state_encode gives the same bytes on seeded states, and both
    decoders read them back (and the V0_23_5 and V1_14_11 layouts, built
    from a seed) to the same state;
  - every instruction tag the JAX program handles (0-9, 14, 15), and the
    malformed cases, through both executors on the same accounts: the same
    account bytes after, and the same success or failure class.
"""

import hashlib

import numpy as np
import pytest

from firedancer_tpu.flamenco import agave_state as jast
from firedancer_tpu.flamenco import executor as jex
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.flamenco import types as jT
from firedancer_tpu.flamenco import vote_program as jvp
from firedancer_tpu_torch.flamenco import agave_state as tast
from firedancer_tpu_torch.flamenco import executor as tex
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.flamenco import types as tT
from firedancer_tpu_torch.flamenco import vote_program as tvp
from firedancer_tpu_torch.protocol.txn import SYSTEM_PROGRAM, VOTE_PROGRAM

PKGS = {"jax": (jast, jvp), "port": (tast, tvp)}


def tower(vs):
    return [(v.lockout.slot, v.lockout.confirmation_count) for v in vs.votes]


def mk(ast, votes=(), root=None, epoch=0, voter=b"v" * 32):
    return ast.VoteState(
        node_pubkey=b"n" * 32,
        authorized_withdrawer=b"w" * 32,
        votes=[ast.LandedVote(0, ast.Lockout(s, c)) for s, c in votes],
        root_slot=root,
        authorized_voters={epoch: voter},
    )


# -- the state machine: tests/test_vote_program.py's cases on both packages -----------


def case_lockout_doubling(ast, vp):
    vs = mk(ast)
    for s in (1, 2, 3, 4):
        vp.process_next_vote_slot(vs, s, 0, s)
    assert tower(vs) == [(1, 4), (2, 3), (3, 2), (4, 1)]
    return vs


def case_lockout_expiry(ast, vp):
    vs = mk(ast)
    for s in (1, 2):
        vp.process_next_vote_slot(vs, s, 0, s)
    vp.process_next_vote_slot(vs, 5, 0, 5)
    assert tower(vs) == [(1, 2), (5, 1)]
    return vs


def case_root_at_31_with_credit(ast, vp):
    vs = mk(ast)
    for s in range(1, 33):
        vp.process_next_vote_slot(vs, s, 0, s)
    assert vs.root_slot == 1 and len(vs.votes) == 31
    assert vs.epoch_credits and vs.epoch_credits[-1][1] == 1
    return vs


def case_credit_grading(ast, vp):
    got = [vp.credits_for_latency(x) for x in (0, 1, 2, 3, 17, 200)]
    assert got == [1, 16, 16, 15, 1, 1]
    vs = mk(ast)
    for s in (10, 12, 30):  # landed at latencies 20, 18 and 0 of current slot 30
        vp.process_next_vote_slot(vs, s, 0, 30)
    return vs


def case_vote_requires_slot_hashes_entry(ast, vp):
    vs = mk(ast)
    with pytest.raises(vp.VoteError):
        vp.process_vote(vs, vp.VoteIx([10], b"h" * 32, None), [(9, b"x" * 32)], 0, 11)
    return vs


def case_vote_hash_must_match(ast, vp):
    vs = mk(ast)
    with pytest.raises(vp.VoteError):
        vp.process_vote(vs, vp.VoteIx([10], b"h" * 32, None), [(10, b"x" * 32)], 0, 11)
    vp.process_vote(vs, vp.VoteIx([10], b"x" * 32, None), [(10, b"x" * 32)], 0, 11)
    assert tower(vs) == [(10, 1)]
    return vs


def case_authorize_rotation_lands_next_epoch(ast, vp):
    vs = mk(ast, voter=b"A" * 32)
    vp.set_new_authorized_voter(vs, b"B" * 32, current_epoch=0, target_epoch=1)
    assert vs.authorized_voter_for(0) == b"A" * 32
    assert vs.authorized_voter_for(1) == b"B" * 32
    assert not vs.prior_voters.is_empty
    with pytest.raises(vp.VoteError):
        vp.set_new_authorized_voter(vs, b"C" * 32, 0, 1)
    return vs


def case_tower_sync_validation(ast, vp):
    vs = mk(ast, votes=[(10, 3), (20, 2), (30, 1)])
    sh = [(40, b"h" * 32)]
    vs.root_slot = 15
    for lockouts, root in (([(40, 1)], 5), ([(40, 1)], None), ([(40, 2), (35, 1)], 20),
                           ([(35, 1), (40, 1)], 20)):
        with pytest.raises(vp.VoteError):
            vp.process_new_vote_state(vs, [ast.Lockout(s, c) for s, c in lockouts], root,
                                      b"h" * 32, sh, 0, 41)
    vp.process_new_vote_state(vs, [ast.Lockout(30, 2), ast.Lockout(40, 1)], 20, b"h" * 32,
                              sh, 0, 41)
    assert vs.root_slot == 20
    assert tower(vs) == [(30, 2), (40, 1)]
    assert vs.epoch_credits[-1][1] == 1
    return vs


def case_tower_sync_cannot_rewind_last_vote(ast, vp):
    vs = mk(ast, votes=[(10, 3), (20, 2), (30, 1)])
    with pytest.raises(vp.VoteError):
        vp.process_new_vote_state(vs, [ast.Lockout(15, 1)], None, b"h" * 32,
                                  [(15, b"h" * 32)], 0, 41)
    return vs


def case_timestamp_same_slot_reassert(ast, vp):
    vs = mk(ast)
    vp._check_and_set_timestamp(vs, 10, 1000)
    vp._check_and_set_timestamp(vs, 10, 1000)
    for slot, ts in ((10, 1001), (9, 1002)):
        with pytest.raises(vp.VoteError):
            vp._check_and_set_timestamp(vs, slot, ts)
    vp._check_and_set_timestamp(vs, 11, 1002)
    return vs


def case_epoch_credit_gap_replaces_zero_entry(ast, vp):
    vs = mk(ast)
    vp.increment_credits(vs, 0, 3)
    vp.increment_credits(vs, 1, 0)
    vp.increment_credits(vs, 3, 2)
    assert vs.epoch_credits == [(0, 3, 0), (3, 5, 3)]
    return vs


def case_account_encoding_round_trip(ast, vp):
    vs = mk(ast, votes=[(5, 2), (6, 1)], root=1)
    vs.epoch_credits = [(0, 7, 3)]
    blob = ast.vote_state_encode(vs).ljust(vp.VOTE_STATE_SIZE, b"\x00")
    vs2 = ast.vote_state_decode(blob)
    assert tower(vs2) == [(5, 2), (6, 1)]
    assert vs2.root_slot == 1 and vs2.epoch_credits == [(0, 7, 3)]
    return vs2


CASES = {f.__name__[len("case_"):]: f for f in (
    case_lockout_doubling, case_lockout_expiry, case_root_at_31_with_credit,
    case_credit_grading, case_vote_requires_slot_hashes_entry, case_vote_hash_must_match,
    case_authorize_rotation_lands_next_epoch, case_tower_sync_validation,
    case_tower_sync_cannot_rewind_last_vote, case_timestamp_same_slot_reassert,
    case_epoch_credit_gap_replaces_zero_entry, case_account_encoding_round_trip)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_machine_case_equals_jax(name):
    out = {who: ast.vote_state_encode(CASES[name](ast, vp)) for who, (ast, vp) in PKGS.items()}
    assert out["port"] == out["jax"]


def test_constants_and_instruction_encoders_equal_jax():
    for nm in ("MAX_LOCKOUT_HISTORY", "INITIAL_LOCKOUT", "VOTE_STATE_SIZE",
               "VOTE_CREDITS_GRACE_SLOTS", "VOTE_CREDITS_MAXIMUM_PER_SLOT",
               "MAX_EPOCH_CREDITS_HISTORY", "AUTHORIZE_VOTER", "AUTHORIZE_WITHDRAWER"):
        assert getattr(tvp, nm) == getattr(jvp, nm), nm
    h = hashlib.sha256(b"enc").digest()
    assert tvp.encode_vote_ix([3, 5, 9], h, -7) == jvp.encode_vote_ix([3, 5, 9], h, -7)
    assert tvp.encode_vote_ix([1], h) == jvp.encode_vote_ix([1], h)
    assert tvp.encode_tower_sync_ix([(4, 2), (5, 1)], 3, h, h[::-1], 99) == \
        jvp.encode_tower_sync_ix([(4, 2), (5, 1)], 3, h, h[::-1], 99)
    assert tvp.encode_initialize_ix(b"n" * 32, b"v" * 32, b"w" * 32, 9) == \
        jvp.encode_initialize_ix(b"n" * 32, b"v" * 32, b"w" * 32, 9)
    # the types' own vote instruction and helpers
    v = (b"\x05" * 32, [7, 8])
    assert tT.VOTE_INSTRUCTION.encode(("vote", tT.Vote([7, 8], v[0], 11))) == \
        jT.VOTE_INSTRUCTION.encode(("vote", jT.Vote([7, 8], v[0], 11)))
    blob = jT.VOTE_INSTRUCTION.encode(("vote", jT.Vote([7, 8], v[0], None)))
    name, got = tT.VOTE_INSTRUCTION.decode(blob)[0]
    assert name == "vote" and (got.slots, got.hash, got.timestamp) == ([7, 8], v[0], None)
    for n in (0, 80, 3762):
        assert tT.rent_exempt_minimum(tT.Rent(), n) == jT.rent_exempt_minimum(jT.Rent(), n)
    for slot in (0, 1, 431_999, 432_000, 10**7):
        assert tT.epoch_of_slot(tT.EpochSchedule(), slot) == \
            jT.epoch_of_slot(jT.EpochSchedule(), slot)
    with pytest.raises(tT.CodecError):
        tT.epoch_of_slot(tT.EpochSchedule(first_normal_slot=10), 3)


# -- the codecs on seeded states --------------------------------------------------------


def _seeded_fields(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def pk():
        return rng.bytes(32)

    n_votes = int(rng.integers(0, 32))
    slots = np.cumsum(rng.integers(1, 5, n_votes)) + int(rng.integers(0, 1000))
    votes = [(int(rng.integers(0, 256)), int(s), n_votes - i) for i, s in enumerate(slots)]
    return dict(
        node=pk(), withdrawer=pk(), commission=int(rng.integers(0, 101)), votes=votes,
        root=None if rng.integers(0, 2) else int(rng.integers(0, 1 << 40)),
        voters={int(e): pk() for e in rng.integers(0, 1000, int(rng.integers(1, 4)))},
        prior=[(pk(), int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32)))
               for _ in range(32)],
        idx=int(rng.integers(0, 32)), empty=bool(rng.integers(0, 2)),
        credits=[(int(rng.integers(0, 1 << 20)), int(rng.integers(0, 1 << 40)),
                  int(rng.integers(0, 1 << 40))) for _ in range(int(rng.integers(0, 6)))],
        ts=(int(rng.integers(0, 1 << 40)), int(rng.integers(-(1 << 40), 1 << 40))))


def _state(ast, f: dict):
    return ast.VoteState(
        node_pubkey=f["node"], authorized_withdrawer=f["withdrawer"],
        commission=f["commission"],
        votes=[ast.LandedVote(lat, ast.Lockout(s, c)) for lat, s, c in f["votes"]],
        root_slot=f["root"], authorized_voters=dict(f["voters"]),
        prior_voters=ast.PriorVoters(list(f["prior"]), f["idx"], f["empty"]),
        epoch_credits=list(f["credits"]), last_timestamp=ast.BlockTimestamp(*f["ts"]))


@pytest.mark.parametrize("seed", range(6))
def test_vote_state_encode_equal_and_round_trips(seed):
    f = _seeded_fields(seed)
    blob = tast.vote_state_encode(_state(tast, f))
    assert blob == jast.vote_state_encode(_state(jast, f))
    padded = blob.ljust(tvp.VOTE_STATE_SIZE, b"\x00")
    for ast in (tast, jast):
        assert tast.vote_state_encode(tast.vote_state_decode(padded)) == blob
        assert ast.vote_state_encode(ast.vote_state_decode(padded)) == blob


def _old_layout(f: dict, tag: int) -> bytes:
    """The V0_23_5 (tag 0) or V1_14_11 (tag 1) bytes of a seeded state,
    written with the JAX package's primitive codecs."""
    u64, pubkey = jT.U64.encode, bytes
    lockouts = jT.U64.encode(len(f["votes"])) + b"".join(
        u64(s) + jT.U32.encode(c) for _, s, c in f["votes"])
    root = jT.Option(jT.U64).encode(f["root"])
    credits = jT.U64.encode(len(f["credits"])) + b"".join(
        u64(e) + u64(c) + u64(p) for e, c, p in f["credits"])
    ts = u64(f["ts"][0]) + jT.I64.encode(f["ts"][1])
    if tag == 1:
        voters = jT.U64.encode(len(f["voters"])) + b"".join(
            u64(e) + f["voters"][e] for e in sorted(f["voters"]))
        prior = b"".join(pubkey(p) + u64(a) + u64(b) for p, a, b in f["prior"])
        return (jT.U32.encode(1) + f["node"] + f["withdrawer"] + bytes([f["commission"]])
                + lockouts + root + voters + prior + u64(f["idx"])
                + jT.Bool.encode(f["empty"]) + credits + ts)
    epoch, voter = min(f["voters"].items())
    prior = b"".join(pubkey(p) + u64(a) + u64(b) + u64(a ^ b) for p, a, b in f["prior"])
    return (jT.U32.encode(0) + f["node"] + voter + u64(epoch) + prior + u64(f["idx"])
            + f["withdrawer"] + bytes([f["commission"]]) + lockouts + root + credits + ts)


@pytest.mark.parametrize("tag", [0, 1])
@pytest.mark.parametrize("seed", range(3))
def test_older_layouts_decode_like_jax(tag, seed):
    f = _seeded_fields(100 + seed)
    if seed == 0:  # an all-zero prior-voters buffer: is_empty in V0_23_5
        f["prior"] = [(bytes(32), 0, 0)] * 32
    blob = _old_layout(f, tag).ljust(tvp.VOTE_STATE_SIZE, b"\x00")
    got, want = tast.vote_state_decode(blob), jast.vote_state_decode(blob)
    assert tast.vote_state_encode(got) == jast.vote_state_encode(want)
    assert [v.latency for v in got.votes] == [0] * len(f["votes"])
    assert tower(got) == [(s, c) for _, s, c in f["votes"]]


def test_unknown_layout_refused_like_jax():
    blob = (3).to_bytes(4, "little") + bytes(100)
    for ast, T in ((tast, tT), (jast, jT)):
        with pytest.raises(T.CodecError):
            ast.vote_state_decode(blob)


# -- every instruction tag through both executors --------------------------------------

VA = hashlib.sha256(b"tvp-va").digest()
V, W, N, X, R = (hashlib.sha256(b"tvp-" + t).digest() for t in (b"V", b"W", b"N", b"X", b"R"))
# the instruction's accounts name these by position in the txn's account list
KEYS = (VA, V, W, N, X, R)
VA_I, V_I, W_I, N_I, X_I, R_I = range(6)
SLOT = 100
SH = [(90 + i, hashlib.sha256(b"tvp-sh%d" % i).digest()) for i in range(10)]
SHD = dict(SH)
VA_LAMPORTS = 10**9


def _va_state(**kw):
    f = dict(node_pubkey=N, authorized_withdrawer=W, authorized_voters={0: V})
    votes = kw.pop("votes", ())
    f.update(kw)
    vs = jast.VoteState(**f)
    vs.votes = [jast.LandedVote(1, jast.Lockout(s, c)) for s, c in votes]
    return jast.vote_state_encode(vs).ljust(jvp.VOTE_STATE_SIZE, b"\x00")


def _u32(n):
    return n.to_bytes(4, "little")


def _u64(n):
    return n.to_bytes(8, "little")


def _upd(lockouts, root, slot, ts=None):
    return jvp.VOTE_STATE_UPDATE.encode(jvp.VoteStateUpdate(
        [jast.Lockout(s, c) for s, c in lockouts], root, SHD[slot], ts))


def _tower(lockouts, root, slot):
    return jvp.TOWER_SYNC.encode(jvp.TowerSync(
        [jast.Lockout(s, c) for s, c in lockouts], root, SHD[slot], None, b"\x07" * 32))


RENT_FLOOR = jT.rent_exempt_minimum(jT.Rent(), jvp.VOTE_STATE_SIZE)
VA_STD = (VA_I, False, True)

# name: (vote account data or None for the initialized default, iaccts
# (index, signer, writable), instruction data, overrides, expected outcome)
SCENARIOS = {
    "init": (bytes(jvp.VOTE_STATE_SIZE), [VA_STD, (N_I, True, False)],
             jvp.encode_initialize_ix(N, V, W, 7), {}, "ok"),
    "init_already_initialized": (None, [VA_STD, (N_I, True, False)],
                                 jvp.encode_initialize_ix(N, V, W, 7), {}, "InstrError"),
    "init_wrong_size": (bytes(100), [VA_STD, (N_I, True, False)],
                        jvp.encode_initialize_ix(N, V, W, 7), {}, "InstrError"),
    "init_node_unsigned": (bytes(jvp.VOTE_STATE_SIZE), [VA_STD, (N_I, False, False)],
                           jvp.encode_initialize_ix(N, V, W, 7), {}, "AcctError"),
    "vote": (None, [VA_STD, (V_I, True, True)], jvp.encode_vote_ix([95], SHD[95]), {}, "ok"),
    "vote_slots_and_timestamp": (None, [VA_STD, (V_I, True, True)],
                                 jvp.encode_vote_ix([93, 95, 97], SHD[97], 1234), {}, "ok"),
    "vote_on_a_tower": (_va_state(votes=[(90, 3), (91, 2), (92, 1)]),
                        [VA_STD, (V_I, True, True)], jvp.encode_vote_ix([96], SHD[96]), {},
                        "ok"),
    "vote_too_old": (_va_state(votes=[(98, 1)]), [VA_STD, (V_I, True, True)],
                     jvp.encode_vote_ix([95], SHD[95]), {}, "InstrError"),
    "vote_slot_not_in_slot_hashes": (None, [VA_STD, (V_I, True, True)],
                                     jvp.encode_vote_ix([120], SHD[95]), {}, "InstrError"),
    "vote_hash_mismatch": (None, [VA_STD, (V_I, True, True)],
                           jvp.encode_vote_ix([95], SHD[96]), {}, "InstrError"),
    "vote_empty_slots": (None, [VA_STD, (V_I, True, True)], jvp.encode_vote_ix([], SHD[95]),
                         {}, "InstrError"),
    "vote_wrong_signer": (None, [VA_STD, (W_I, True, True)], jvp.encode_vote_ix([95], SHD[95]),
                          {}, "AcctError"),
    "vote_uninitialized": (bytes(jvp.VOTE_STATE_SIZE), [VA_STD, (V_I, True, True)],
                           jvp.encode_vote_ix([95], SHD[95]), {}, "InstrError"),
    "vote_timestamp_too_old": (_va_state(last_timestamp=jast.BlockTimestamp(99, 5000)),
                               [VA_STD, (V_I, True, True)],
                               jvp.encode_vote_ix([95], SHD[95], 10), {}, "InstrError"),
    "vote_account_not_vote_owned": (None, [VA_STD, (V_I, True, True)],
                                    jvp.encode_vote_ix([95], SHD[95]),
                                    {"owner": SYSTEM_PROGRAM}, "AcctError"),
    "vote_account_readonly": (None, [(VA_I, False, False), (V_I, True, True)],
                              jvp.encode_vote_ix([95], SHD[95]), {}, "AcctError"),
    "vote_malformed_payload": (None, [VA_STD, (V_I, True, True)],
                               _u32(2) + _u64(1 << 40), {}, "InstrError"),
    "vote_switch": (None, [VA_STD, (V_I, True, True)],
                    jvp.encode_vote_ix([95], SHD[95]) + b"\x09" * 32, {}, "ok"),
    "vote_switch_tag_6": (None, [VA_STD, (V_I, True, True)],
                          _u32(6) + jvp.encode_vote_ix([95], SHD[95])[4:] + b"\x09" * 32, {},
                          "ok"),
    "authorize_voter_by_voter": (None, [VA_STD, (V_I, True, False)],
                                 _u32(1) + X + _u32(0), {}, "ok"),
    "authorize_voter_by_withdrawer": (None, [VA_STD, (W_I, True, False)],
                                      _u32(1) + X + _u32(0), {}, "ok"),
    "authorize_voter_unsigned": (None, [VA_STD, (N_I, True, False)],
                                 _u32(1) + X + _u32(0), {}, "AcctError"),
    "authorize_voter_too_soon": (_va_state(authorized_voters={0: V, 1: X}),
                                 [VA_STD, (V_I, True, False)], _u32(1) + R + _u32(0), {},
                                 "InstrError"),
    "authorize_withdrawer": (None, [VA_STD, (W_I, True, False)], _u32(1) + X + _u32(1), {},
                             "ok"),
    "authorize_withdrawer_by_voter": (None, [VA_STD, (V_I, True, False)],
                                      _u32(1) + X + _u32(1), {}, "AcctError"),
    "authorize_bad_kind": (None, [VA_STD, (W_I, True, False)], _u32(1) + X + _u32(2), {},
                           "InstrError"),
    "authorize_checked": (None, [VA_STD, (R_I, False, False), (V_I, True, False),
                                 (X_I, True, False)], _u32(7) + _u32(0), {}, "ok"),
    "authorize_checked_withdrawer": (None, [VA_STD, (R_I, False, False), (W_I, True, False),
                                            (X_I, True, False)], _u32(7) + _u32(1), {}, "ok"),
    "authorize_checked_three_accounts": (None, [VA_STD, (R_I, False, False),
                                                (V_I, True, False)], _u32(7) + _u32(0), {},
                                         "AcctError"),
    "authorize_checked_new_unsigned": (None, [VA_STD, (R_I, False, False), (V_I, True, False),
                                              (X_I, False, False)], _u32(7) + _u32(0), {},
                                       "AcctError"),
    "withdraw_partial": (None, [VA_STD, (R_I, False, True), (W_I, True, False)],
                         _u32(3) + _u64(VA_LAMPORTS - RENT_FLOOR), {}, "ok"),
    "withdraw_below_rent_floor": (None, [VA_STD, (R_I, False, True), (W_I, True, False)],
                                  _u32(3) + _u64(VA_LAMPORTS - RENT_FLOOR + 1), {},
                                  "FundsError"),
    "withdraw_over_balance": (None, [VA_STD, (R_I, False, True), (W_I, True, False)],
                              _u32(3) + _u64(VA_LAMPORTS + 1), {}, "FundsError"),
    "withdraw_all_inactive": (None, [VA_STD, (R_I, False, True), (W_I, True, False)],
                              _u32(3) + _u64(VA_LAMPORTS), {}, "ok"),
    "withdraw_all_active": (_va_state(epoch_credits=[(0, 5, 0)]),
                            [VA_STD, (R_I, False, True), (W_I, True, False)],
                            _u32(3) + _u64(VA_LAMPORTS), {}, "InstrError"),
    "withdraw_recipient_readonly": (None, [VA_STD, (R_I, False, False), (W_I, True, False)],
                                    _u32(3) + _u64(5), {}, "AcctError"),
    "withdraw_no_recipient": (None, [VA_STD], _u32(3) + _u64(5), {}, "AcctError"),
    "withdraw_unsigned": (None, [VA_STD, (R_I, False, True), (V_I, True, False)],
                          _u32(3) + _u64(5), {}, "AcctError"),
    "update_validator_identity": (None, [VA_STD, (X_I, True, False), (W_I, True, False)],
                                  _u32(4), {}, "ok"),
    "update_validator_identity_unsigned": (None, [VA_STD, (X_I, False, False),
                                                  (W_I, True, False)], _u32(4), {},
                                           "AcctError"),
    "update_commission_down": (_va_state(commission=10), [VA_STD, (W_I, True, False)],
                               _u32(5) + bytes([5]), {}, "ok"),
    "update_commission_up_early": (_va_state(commission=10), [VA_STD, (W_I, True, False)],
                                   _u32(5) + bytes([50]), {}, "ok"),
    "update_commission_up_late": (_va_state(commission=10), [VA_STD, (W_I, True, False)],
                                  _u32(5) + bytes([50]), {"slot": 300_000}, "InstrError"),
    "update_commission_unsigned": (None, [VA_STD, (V_I, True, False)], _u32(5) + bytes([1]),
                                   {}, "AcctError"),
    "update_vote_state": (None, [VA_STD, (V_I, True, False)],
                          _u32(8) + _upd([(93, 2), (95, 1)], None, 95, 77), {}, "ok"),
    "update_vote_state_switch": (None, [VA_STD, (V_I, True, False)],
                                 _u32(9) + _upd([(93, 2), (95, 1)], None, 95) + b"\x03" * 32,
                                 {}, "ok"),
    "tower_sync": (_va_state(votes=[(90, 3), (91, 2), (92, 1)]), [VA_STD, (V_I, True, False)],
                   _u32(14) + _tower([(92, 2), (96, 1)], 91, 96), {}, "ok"),
    "tower_sync_switch": (None, [VA_STD, (V_I, True, False)],
                          _u32(15) + _tower([(94, 2), (96, 1)], None, 96) + b"\x04" * 32, {},
                          "ok"),
    "tower_sync_encoder": (None, [VA_STD, (V_I, True, False)],
                           jvp.encode_tower_sync_ix([(93, 2), (95, 1)], None, SHD[95]), {},
                           "ok"),
    "tower_sync_disordered": (None, [VA_STD, (V_I, True, False)],
                              _u32(14) + _tower([(96, 2), (95, 1)], None, 95), {},
                              "InstrError"),
    "tower_sync_root_rollback": (_va_state(root_slot=92), [VA_STD, (V_I, True, False)],
                                 _u32(14) + _tower([(96, 1)], 90, 96), {}, "InstrError"),
    "tower_sync_too_many": (None, [VA_STD, (V_I, True, False)],
                            _u32(14) + jvp.TOWER_SYNC.encode(jvp.TowerSync(
                                [jast.Lockout(s, 40 - s) for s in range(1, 34)] + [
                                    jast.Lockout(95, 1)], None, SHD[95], None, bytes(32))),
                            {}, "InstrError"),
    "tower_sync_unsigned": (None, [VA_STD, (W_I, True, False)],
                            _u32(14) + _tower([(96, 1)], None, 96), {}, "AcctError"),
    "unsupported_tag": (None, [VA_STD, (V_I, True, False)], _u32(10), {}, "InstrError"),
    "truncated_tag": (None, [VA_STD], b"\x02\x00", {}, "InstrError"),
    "no_accounts": (None, [], jvp.encode_vote_ix([95], SHD[95]), {}, "AcctError"),
}


def _run_instr(ex, rt, T, name):
    data0, iaccts, data, over, _ = SCENARIOS[name]
    va = jex.acct_encode(VA_LAMPORTS, over.get("owner", VOTE_PROGRAM),
                         data=_va_state() if data0 is None else data0)
    vals = {VA: va, **{k: jex.acct_encode(10**9) for k in KEYS[1:]}}
    accounts = [ex.Account.from_value(k, vals[k]) for k in KEYS]
    sysvars = rt.default_sysvars(over.get("slot", SLOT))
    sysvars["slot_hashes"] = T.SLOT_HASHES.encode([T.SlotHash(s, h) for s, h in SH])
    ctx = ex.TxnCtx(accounts=accounts, signer=[False] * len(KEYS),
                    writable=[True] * len(KEYS), sysvars=sysvars)
    ia = [ex.InstrAccount(i, s, w) for i, s, w in iaccts]
    try:
        ex.Executor().execute_instr(ctx, VOTE_PROGRAM, ia, data)
        outcome = "ok"
    except Exception as e:  # the outcome's class is what both packages must share
        outcome = type(e).__name__
    return outcome, [a.to_value() for a in ctx.accounts], ctx.cu_used


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_instruction_equals_jax(name):
    j = _run_instr(jex, jrt, jT, name)
    t = _run_instr(tex, trt, tT, name)
    assert t == j
    assert t[0] == SCENARIOS[name][4]
    if t[0] == "ok" and name != "withdraw_all_inactive":
        # the vote account still decodes after every instruction that succeeds
        assert tast.vote_state_decode(tex.acct_decode(t[1][VA_I])[3]) is not None


def test_tags_cover_the_jax_program():
    """Every tag the JAX program dispatches has a scenario that succeeds."""
    ok_tags = {int.from_bytes(d[:4], "little") for d0, _, d, _, want in SCENARIOS.values()
               if want == "ok"}
    assert ok_tags == {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 14, 15}
