"""The port's stake program, epoch stakes and rewards (flamenco/stake.py),
the stake half of flamenco/agave_state.py and the config program
(flamenco/config_program.py) against the JAX package's, exactly:

  - the stake cases of tests/test_stake.py on both packages (initialize and
    delegate, the staker signature, the warmup ramp, locked stake, the
    forged-epoch regression, split, collect_stakes and epoch_rewards,
    apply_rewards, the partitioned distribution): the same results and
    account bytes;
  - seeded scenarios of every stake and config instruction with the
    malformed, unauthorised, wrong-owner and fail-closed cases through both
    executors on the same accounts: the same account bytes, CU and outcome;
  - effective_stake, locked_stake and the rewards functions on seeded
    states;
  - StakeStateV2 (every variant), to_internal_stake and
    vote_account_summary on seeded states;
  - stake and config txns through execute_block: the same statuses, fees
    and bank hash.
"""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.flamenco import agave_state as jast
from firedancer_tpu.flamenco import config_program as jcfg
from firedancer_tpu.flamenco import executor as jex
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.flamenco import stake as jst
from firedancer_tpu.flamenco import types as jT
from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu_torch.flamenco import agave_state as tast
from firedancer_tpu_torch.flamenco import config_program as tcfg
from firedancer_tpu_torch.flamenco import executor as tex
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.flamenco import stake as tst
from firedancer_tpu_torch.flamenco import types as tT
from firedancer_tpu_torch.funk import Funk as TFunk
from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
from firedancer_tpu_torch.protocol import txn as ft

PKGS = {
    "jax": SimpleNamespace(st=jst, ex=jex, rt=jrt, T=jT, ast=jast, cfg=jcfg, Funk=JFunk, kw={}),
    "port": SimpleNamespace(st=tst, ex=tex, rt=trt, T=tT, ast=tast, cfg=tcfg, Funk=TFunk,
                            kw={"device": "cpu"}),
}
SYS = ft.SYSTEM_PROGRAM
STAKER, WITHDRAWER, VOTER = b"s" * 32, b"w" * 32, b"v" * 32


def both(case):
    """Run `case` on each package; the two outcomes must be equal."""
    out = {n: case(p) for n, p in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# -- tests/test_stake.py's cases on both packages -----------------------------------------


def _stake_acct(p, key=b"K" * 32, lamports=1_000_000):
    return p.ex.Account(key, lamports, p.st.STAKE_PROGRAM, False, bytearray(p.st._DATA_LEN))


def _auth_acct(p, key):
    return p.ex.Account(key, 0, SYS, False, bytearray())


def _ctx(p, *accts):
    return p.ex.TxnCtx(accounts=list(accts), signer=[True] * len(accts),
                       writable=[True] * len(accts))


def _set_epoch(p, ctx, epoch):
    ctx.sysvars["clock"] = p.T.CLOCK.encode(p.T.Clock(epoch=epoch))


def _ix(tag, tail=b""):
    return tag.to_bytes(4, "little") + tail


def _delegated_ctx(p, ex, lamports=1_000_000):
    stake = _stake_acct(p, lamports=lamports)
    vote = p.ex.Account(VOTER, 1, SYS, False, bytearray())
    ctx = _ctx(p, stake, vote, _auth_acct(p, STAKER))
    ia = [p.ex.InstrAccount(0, False, True), p.ex.InstrAccount(1, False, False),
          p.ex.InstrAccount(2, True, False)]
    ex.execute_instr(ctx, p.st.STAKE_PROGRAM, ia[:1], _ix(0, STAKER + WITHDRAWER))
    _set_epoch(p, ctx, 10)
    ex.execute_instr(ctx, p.st.STAKE_PROGRAM, ia, _ix(1))
    return ctx, stake


def _values(ctx):
    return [a.to_value() for a in ctx.accounts], ctx.cu_used


def case_initialize_delegate_roundtrip(p):
    ctx, stake = _delegated_ctx(p, p.ex.Executor())
    st = p.st.StakeState.decode(bytes(stake.data))
    assert (st.state, st.voter, st.stake, st.activation_epoch) == \
        (p.st.STATE_DELEGATED, VOTER, 1_000_000, 10)
    return _values(ctx)


def case_delegate_requires_staker_signature(p):
    ex = p.ex.Executor()
    stake = _stake_acct(p)
    ctx = _ctx(p, stake, p.ex.Account(VOTER, 1, SYS, False, bytearray()))
    ex.execute_instr(ctx, p.st.STAKE_PROGRAM, [p.ex.InstrAccount(0, False, True)],
                     _ix(0, STAKER + WITHDRAWER))
    with pytest.raises(p.ex.InstrError, match="staker signature"):
        ex.execute_instr(ctx, p.st.STAKE_PROGRAM, [p.ex.InstrAccount(0, False, True),
                                                   p.ex.InstrAccount(1, False, False)], _ix(1))
    return _values(ctx)


def case_warmup_ramp(p):
    st = p.st.StakeState(state=p.st.STATE_DELEGATED, voter=VOTER, stake=1000,
                         activation_epoch=10)
    out = [p.st.effective_stake(st, e) for e in (9, 10, 11, 12, 14, 20)]
    assert out == [0, 0, 250, 500, 1000, 1000]
    st.deactivation_epoch = 20
    out += [p.st.effective_stake(st, e) for e in (21, 24)]
    assert out[-2:] == [750, 0]
    return out


def _withdraw_setup(p):
    ex = p.ex.Executor()
    ctx, stake = _delegated_ctx(p, ex)
    dest = _auth_acct(p, b"d" * 32)
    ctx.accounts += [dest, _auth_acct(p, WITHDRAWER)]
    ia = [p.ex.InstrAccount(0, False, True), p.ex.InstrAccount(3, False, True),
          p.ex.InstrAccount(4, True, False)]
    return ex, ctx, stake, dest, ia


def case_withdraw_respects_locked_stake(p):
    ex, ctx, stake, dest, ia = _withdraw_setup(p)
    _set_epoch(p, ctx, 14)
    with pytest.raises(p.ex.InstrError):  # FundsError: the full 1M is effective
        ex.execute_instr(ctx, p.st.STAKE_PROGRAM, ia, _ix(3, (1).to_bytes(8, "little")))
    _set_epoch(p, ctx, 20)
    ex.execute_instr(ctx, p.st.STAKE_PROGRAM, [p.ex.InstrAccount(0, False, True),
                                               p.ex.InstrAccount(2, True, False)], _ix(2))
    _set_epoch(p, ctx, 24)
    ex.execute_instr(ctx, p.st.STAKE_PROGRAM, ia, _ix(3, (400_000).to_bytes(8, "little")))
    assert (dest.lamports, stake.lamports) == (400_000, 600_000)
    return _values(ctx)


def case_withdraw_ignores_forged_epoch_in_instruction_data(p):
    ex, ctx, stake, _, ia = _withdraw_setup(p)
    _set_epoch(p, ctx, 14)
    forged = _ix(3, (400_000).to_bytes(8, "little")) + (10**6).to_bytes(8, "little")
    with pytest.raises(p.ex.InstrError):
        ex.execute_instr(ctx, p.st.STAKE_PROGRAM, ia, forged)
    assert stake.lamports == 1_000_000
    return _values(ctx)


def case_split(p):
    ex = p.ex.Executor()
    ctx, stake = _delegated_ctx(p, ex)
    new = _stake_acct(p, key=b"N" * 32, lamports=0)
    ctx.accounts.append(new)
    ex.execute_instr(ctx, p.st.STAKE_PROGRAM,
                     [p.ex.InstrAccount(0, False, True), p.ex.InstrAccount(3, False, True),
                      p.ex.InstrAccount(2, True, False)], _ix(4, (250_000).to_bytes(8, "little")))
    st, nst = (p.st.StakeState.decode(bytes(a.data)) for a in (stake, new))
    assert (st.stake, nst.stake) == (750_000, 250_000)
    assert nst.voter == VOTER and nst.activation_epoch == st.activation_epoch
    return _values(ctx)


def case_collect_stakes_and_rewards(p):
    def entry(key, stake, voter):
        return p.st.StakeEntry(key, p.st.StakeState(state=p.st.STATE_DELEGATED, voter=voter,
                                                    stake=stake, activation_epoch=0))

    v1, v2 = b"V1" + bytes(30), b"V2" + bytes(30)
    entries = [entry(b"a" * 32, 1000, v1), entry(b"b" * 32, 3000, v2), entry(b"c" * 32, 500, v1)]
    stakes = p.st.collect_stakes(entries, epoch=10)
    assert stakes == {v1: 1500, v2: 3000}
    rewards = p.st.epoch_rewards(entries, {v1: 10, v2: 10}, epoch=10, pot=45_000)
    assert rewards == {b"a" * 32: 10_000, b"b" * 32: 30_000, b"c" * 32: 5_000}
    return stakes, rewards


def case_apply_rewards_compounds(p):
    a = _stake_acct(p)
    st = p.st.StakeState(state=p.st.STATE_DELEGATED, voter=VOTER, stake=500, activation_epoch=0)
    a.data[: p.st._DATA_LEN] = st.encode()
    p.st.apply_rewards({a.key: a}, {a.key: 100})
    assert a.lamports == 1_000_100 and p.st.StakeState.decode(bytes(a.data)).stake == 600
    return a.to_value()


def case_partitioned_rewards_distribution(p):
    pbh = hashlib.sha256(b"pr-seed").digest()
    rewards = {hashlib.sha256(b"pr%d" % i).digest(): 10 + i for i in range(100)}
    parts = p.st.partition_rewards(rewards, pbh)
    assert sum(len(x) for x in parts) == len(rewards)
    assert p.st.partition_rewards(rewards, pbh) == parts
    counts = [p.st.reward_partition_count(n) for n in (1, 4096, 4097, 3 * 4096 + 1)]
    assert counts == [1, 1, 2, 4]
    many = {hashlib.sha256(b"many%d" % i).digest(): i for i in range(4097)}
    assignment = [p.st.reward_partition_of(k, 2, pbh) for k in list(many)[:64]]
    funk = p.Funk()
    missing = next(iter(rewards))
    for k in rewards:
        if k != missing:
            funk.rec_insert(None, k, p.rt.acct_build(1000))
    delegated = list(rewards)[5]
    funk.rec_insert(None, delegated, p.ex.acct_encode(
        1000, p.st.STAKE_PROGRAM, data=p.st.StakeState(state=p.st.STATE_DELEGATED,
                                                       stake=700).encode()))
    paid = sum(p.st.distribute_reward_partition(funk, None, x) for x in parts)
    assert paid == sum(rewards.values()) - rewards[missing]
    assert funk.rec_query(None, missing) is None
    blob = p.st.epoch_rewards_sysvar(
        distribution_starting_block_height=7, num_partitions=len(parts), parent_blockhash=pbh,
        total_points=123456789, total_rewards=paid, distributed_rewards=paid, active=True)
    assert len(blob) == 81 and blob[-1] == 1
    return parts, assignment, paid, blob, [funk.rec_query(None, k) for k in rewards]


CASES = [case_initialize_delegate_roundtrip, case_delegate_requires_staker_signature,
         case_warmup_ramp, case_withdraw_respects_locked_stake,
         case_withdraw_ignores_forged_epoch_in_instruction_data, case_split,
         case_collect_stakes_and_rewards, case_apply_rewards_compounds,
         case_partitioned_rewards_distribution]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_stake_case_equals_jax(case):
    both(case)


# -- every stake instruction, through both executors ----------------------------------------

STAKE, VOTE, DEST, AUTH, OTHER = (bytes([0xC0 + i]) * 32 for i in range(5))
KEYS = [STAKE, VOTE, DEST, AUTH, OTHER]
S_, V_, D_, A_, O_ = range(5)
EPOCH = 30
UNINIT = tst.StakeState().encode()
INIT = tst.StakeState(state=tst.STATE_INIT, staker=AUTH, withdrawer=AUTH).encode()


def _delegated(act=EPOCH - 10, deact=tst.U64_MAX, stake=600_000):
    return tst.StakeState(state=tst.STATE_DELEGATED, staker=AUTH, withdrawer=AUTH, voter=VOTE,
                          stake=stake, activation_epoch=act, deactivation_epoch=deact).encode()


SW, AS, DW = (S_, False, True), (A_, True, False), (D_, False, True)
U64 = lambda n: n.to_bytes(8, "little")  # noqa: E731
# name: (stake data, stake owner, dest data (a stake account when given),
# instruction accounts, data, outcome)
STAKE_SCENARIOS = {
    "initialize": (UNINIT, "stake", None, [SW], _ix(0, AUTH + AUTH), "ok"),
    "initialize_twice": (INIT, "stake", None, [SW], _ix(0, AUTH + AUTH), "AcctError"),
    "initialize_short_account": (UNINIT[:50], "stake", None, [SW], _ix(0, AUTH + AUTH),
                                 "AcctError"),
    "initialize_malformed": (UNINIT, "stake", None, [SW], _ix(0, AUTH), "AcctError"),
    "initialize_readonly": (UNINIT, "stake", None, [(S_, False, False)], _ix(0, AUTH + AUTH),
                            "AcctError"),
    "initialize_wrong_owner": (UNINIT, "system", None, [SW], _ix(0, AUTH + AUTH), "AcctError"),
    "initialize_no_accounts": (UNINIT, "stake", None, [], _ix(0, AUTH + AUTH), "AcctError"),
    "delegate": (INIT, "stake", None, [SW, (V_, False, False), AS], _ix(1), "ok"),
    "redelegate": (_delegated(), "stake", None, [SW, (V_, False, False), AS], _ix(1), "ok"),
    "delegate_uninitialized": (UNINIT, "stake", None, [SW, (V_, False, False), AS], _ix(1),
                               "AcctError"),
    "delegate_unsigned": (INIT, "stake", None, [SW, (V_, False, False), (A_, False, False)],
                          _ix(1), "AcctError"),
    "delegate_other_signer": (INIT, "stake", None, [SW, (V_, False, False), (O_, True, False)],
                              _ix(1), "AcctError"),
    "delegate_no_vote": (INIT, "stake", None, [SW], _ix(1), "AcctError"),
    "delegate_wrong_owner": (INIT, "vote", None, [SW, (V_, False, False), AS], _ix(1),
                             "AcctError"),
    "deactivate": (_delegated(), "stake", None, [SW, AS], _ix(2), "ok"),
    "deactivate_undelegated": (INIT, "stake", None, [SW, AS], _ix(2), "AcctError"),
    "deactivate_unsigned": (_delegated(), "stake", None, [SW, (O_, True, False)], _ix(2),
                            "AcctError"),
    "withdraw_initialized": (INIT, "stake", None, [SW, DW, AS], _ix(3, U64(5000)), "ok"),
    "withdraw_locked": (_delegated(), "stake", None, [SW, DW, AS], _ix(3, U64(500_000)),
                        "FundsError"),
    "withdraw_free_part": (_delegated(), "stake", None, [SW, DW, AS], _ix(3, U64(400_000)),
                           "ok"),
    "withdraw_cooled_down": (_delegated(deact=EPOCH - 4), "stake", None, [SW, DW, AS],
                             _ix(3, U64(900_000)), "ok"),
    "withdraw_cooling": (_delegated(deact=EPOCH - 2), "stake", None, [SW, DW, AS],
                         _ix(3, U64(900_000)), "FundsError"),
    "withdraw_uninitialized_self_signed": (UNINIT, "stake", None, [(S_, True, True), DW],
                                           _ix(3, U64(10)), "ok"),
    "withdraw_uninitialized_unsigned": (UNINIT, "stake", None, [SW, DW, AS], _ix(3, U64(10)),
                                        "AcctError"),
    "withdraw_wrong_withdrawer": (INIT, "stake", None, [SW, DW, (O_, True, False)],
                                  _ix(3, U64(10)), "AcctError"),
    "withdraw_past_balance": (INIT, "stake", None, [SW, DW, AS], _ix(3, U64(10**7)),
                              "FundsError"),
    "withdraw_to_itself": (INIT, "stake", None, [SW, SW, AS], _ix(3, U64(10)), "ok"),
    "withdraw_dest_readonly": (INIT, "stake", None, [SW, (D_, False, False), AS],
                               _ix(3, U64(10)), "AcctError"),
    "withdraw_malformed": (INIT, "stake", None, [SW, DW, AS], _ix(3, b"\x01"), "AcctError"),
    "split": (_delegated(), "stake", UNINIT, [SW, DW, AS], _ix(4, U64(100_000)), "ok"),
    "split_too_much": (_delegated(), "stake", UNINIT, [SW, DW, AS], _ix(4, U64(700_000)),
                       "FundsError"),
    "split_into_used": (_delegated(), "stake", INIT, [SW, DW, AS], _ix(4, U64(100)),
                        "AcctError"),
    "split_into_small": (_delegated(), "stake", UNINIT[:20], [SW, DW, AS], _ix(4, U64(100)),
                         "AcctError"),
    "split_into_system_account": (_delegated(), "stake", None, [SW, DW, AS], _ix(4, U64(100)),
                                  "AcctError"),
    "split_undelegated": (INIT, "stake", UNINIT, [SW, DW, AS], _ix(4, U64(100)), "AcctError"),
    "split_unsigned": (_delegated(), "stake", UNINIT, [SW, DW, (O_, True, False)],
                       _ix(4, U64(100)), "AcctError"),
    "unknown_tag": (INIT, "stake", None, [SW], _ix(9), "ok"),
    "short_data": (INIT, "stake", None, [SW], b"\x01", "ok"),
}
OWNERS = {"stake": tst.STAKE_PROGRAM, "system": SYS, "vote": ft.VOTE_PROGRAM}


def _run_stake(p, name, *, clock=True):
    data0, owner, dest0, iaccts, data, _ = STAKE_SCENARIOS[name]
    vals = {STAKE: p.ex.acct_encode(1_000_000, OWNERS[owner], data=data0),
            VOTE: p.ex.acct_encode(1), AUTH: p.ex.acct_encode(10**9),
            OTHER: p.ex.acct_encode(10**9),
            DEST: p.ex.acct_encode(0, tst.STAKE_PROGRAM, data=dest0) if dest0 is not None
            else None}
    accounts = [p.ex.Account.from_value(k, vals[k]) for k in KEYS]
    sysvars = {"clock": p.T.CLOCK.encode(p.T.Clock(slot=5, epoch=EPOCH))} if clock else {}
    ctx = p.ex.TxnCtx(accounts=accounts, signer=[False] * len(KEYS),
                      writable=[True] * len(KEYS), sysvars=sysvars)
    ia = [p.ex.InstrAccount(i, s, w) for i, s, w in iaccts]
    try:
        p.ex.Executor().execute_instr(ctx, tst.STAKE_PROGRAM, ia, data)
        outcome = "ok"
    except Exception as e:  # the outcome's class is what both packages must share
        outcome = type(e).__name__
    return outcome, [a.to_value() for a in ctx.accounts], ctx.cu_used


@pytest.mark.parametrize("name", sorted(STAKE_SCENARIOS))
def test_stake_instruction_equals_jax(name):
    t = _run_stake(PKGS["port"], name)
    assert t == _run_stake(PKGS["jax"], name)
    assert t[0] == STAKE_SCENARIOS[name][5]


@pytest.mark.parametrize("name", ["delegate", "deactivate", "withdraw_free_part"])
def test_stake_fails_closed_without_the_clock_like_jax(name):
    t = _run_stake(PKGS["port"], name, clock=False)
    assert t == _run_stake(PKGS["jax"], name, clock=False)
    assert t[0] == "AcctError"


def test_stake_scenarios_cover_every_tag():
    ok = {int.from_bytes(d[:4], "little") for *_, d, w in STAKE_SCENARIOS.values() if w == "ok"}
    assert {0, 1, 2, 3, 4} <= ok


@pytest.mark.parametrize("seed", range(4))
def test_ramp_and_rewards_on_seeded_states_equal_jax(seed):
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(24):
        kw = dict(state=int(rng.integers(0, 3)), voter=bytes([int(rng.integers(0, 4))]) * 32,
                  stake=int(rng.integers(0, 10**12)), activation_epoch=int(rng.integers(0, 40)),
                  deactivation_epoch=(int(rng.integers(0, 60)) if rng.integers(0, 2)
                                      else tst.U64_MAX))
        t, j = tst.StakeState(**kw), jst.StakeState(**kw)
        assert t.encode() == j.encode()
        assert tst.StakeState.decode(t.encode()).__dict__ == jst.StakeState.decode(j.encode()).__dict__
        for e in (0, 5, 20, 41, 70):
            assert tst.effective_stake(t, e) == jst.effective_stake(j, e)
            assert tst.locked_stake(t, e) == jst.locked_stake(j, e)
        entries.append((hashlib.sha256(b"e%d/%d" % (seed, i)).digest(), kw))
    credits = {bytes([v]) * 32: int(rng.integers(0, 1000)) for v in range(4)}
    for epoch in (10, 45):
        te = [tst.StakeEntry(k, tst.StakeState(**kw)) for k, kw in entries]
        je = [jst.StakeEntry(k, jst.StakeState(**kw)) for k, kw in entries]
        assert tst.collect_stakes(te, epoch) == jst.collect_stakes(je, epoch)
        rw = tst.epoch_rewards(te, credits, epoch=epoch, pot=10**9)
        assert rw == jst.epoch_rewards(je, credits, epoch=epoch, pot=10**9)
        pbh = rng.bytes(32)
        assert tst.partition_rewards(rw, pbh) == jst.partition_rewards(rw, pbh)


# -- the stake half of agave_state ---------------------------------------------------------


def _stake_state_v2(ast, rng, kind):
    meta = ast.Meta(rent_exempt_reserve=int(rng.integers(0, 2**40)),
                    authorized=ast.Authorized(rng.bytes(32), rng.bytes(32)),
                    lockup=ast.Lockup(int(rng.integers(-2**40, 2**40)),
                                      int(rng.integers(0, 2**20)), rng.bytes(32)))
    if kind == "initialized":
        return (kind, meta)
    if kind == "stake":
        d = ast.Delegation(rng.bytes(32), int(rng.integers(0, 2**50)), int(rng.integers(0, 500)),
                           int(rng.integers(0, 500)) if rng.integers(0, 2) else ast.U64_MAX,
                           float(rng.random()))
        return (kind, ast.StakeMetaPair(meta, ast.StakeV2(d, int(rng.integers(0, 2**30))),
                                        int(rng.integers(0, 256))))
    return (kind, None)


@pytest.mark.parametrize("seed", range(4))
def test_stake_state_v2_codecs_equal_jax(seed):
    for kind in ("uninitialized", "initialized", "stake", "rewards_pool"):
        rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        t = tast.STAKE_STATE_V2.encode(_stake_state_v2(tast, rng_t, kind))
        j = jast.STAKE_STATE_V2.encode(_stake_state_v2(jast, rng_j, kind))
        assert t == j
        (tk, tv), toff = tast.STAKE_STATE_V2.decode(t, 0)
        (jk, jv), joff = jast.STAKE_STATE_V2.decode(j, 0)
        assert (tk, toff) == (jk, joff) == (kind, len(t))
        assert repr(tv) == repr(jv).replace("firedancer_tpu.", "firedancer_tpu_torch.")
        ti, ji = tast.to_internal_stake(t), jast.to_internal_stake(j)
        assert (ti is None) == (ji is None) == (kind in ("uninitialized", "rewards_pool"))
        if ti is not None:
            assert ti.__dict__ == ji.__dict__
    with pytest.raises(tT.CodecError):
        tast.STAKE_STATE_V2.decode((7).to_bytes(4, "little"), 0)


@pytest.mark.parametrize("seed", range(2))
def test_vote_account_summary_equals_jax(seed):
    rng = np.random.default_rng(seed)
    vs = tast.VoteState(
        node_pubkey=rng.bytes(32), authorized_withdrawer=rng.bytes(32),
        commission=int(rng.integers(0, 101)),
        votes=[tast.LandedVote(int(rng.integers(0, 8)), tast.Lockout(100 + i, 31 - i))
               for i in range(int(rng.integers(0, 6)))],
        root_slot=int(rng.integers(0, 99)) if rng.integers(0, 2) else None,
        authorized_voters={0: rng.bytes(32), 7: rng.bytes(32)},
        epoch_credits=[(e, 100 * (e + 1), 100 * e) for e in range(int(rng.integers(0, 4)))])
    data = tast.vote_state_encode(vs)
    for epoch in (0, 6, 7, 50):
        assert tast.vote_account_summary(data, epoch=epoch) == \
            jast.vote_account_summary(data, epoch=epoch)


# -- the config program ----------------------------------------------------------------------

CFG, CAUTH, COTHER = b"\xd1" * 32, b"\xd2" * 32, b"\xd3" * 32
CKEYS = [CFG, CAUTH, COTHER]
C_, CA_, CO_ = range(3)


def _keys(*ks, payload=b"\x05" * 8):
    return tcfg.build_keys(list(ks), payload)


CW = (C_, False, True)
# name: (config data, owner, instruction accounts, data, outcome)
CONFIG_SCENARIOS = {
    "fresh_self_signed": (bytes(64), "config", [(C_, True, True)], _keys((CAUTH, True)), "ok"),
    "fresh_unsigned": (bytes(64), "config", [CW, (CA_, True, False)], _keys((CAUTH, True)),
                       "AcctError"),
    "store_by_signer": (_keys((CAUTH, True)).ljust(64, b"\x00"), "config",
                        [CW, (CA_, True, False)], _keys((CAUTH, True), payload=b"\x09" * 20), "ok"),
    "store_rotates_authority": (_keys((CAUTH, True)).ljust(64, b"\x00"), "config",
                                [CW, (CA_, True, False)], _keys((COTHER, True)), "ok"),
    "store_missing_signer": (_keys((CAUTH, True)).ljust(64, b"\x00"), "config",
                             [CW, (CO_, True, False)], _keys((CAUTH, True)), "AcctError"),
    "store_unsigned_key_not_needed": (_keys((CAUTH, False)).ljust(64, b"\x00"), "config",
                                      [CW], _keys((CAUTH, False)), "ok"),
    "store_too_large": (_keys((CAUTH, True)).ljust(64, b"\x00"), "config",
                        [CW, (CA_, True, False)], _keys((CAUTH, True), payload=bytes(60)),
                        "AcctError"),
    "store_readonly": (_keys((CAUTH, True)).ljust(64, b"\x00"), "config",
                       [(C_, False, False), (CA_, True, False)], _keys((CAUTH, True)),
                       "AcctError"),
    "store_wrong_owner": (_keys((CAUTH, True)).ljust(64, b"\x00"), "system",
                          [CW, (CA_, True, False)], _keys((CAUTH, True)), "AcctError"),
    "store_truncated_keys": (_keys((CAUTH, True)).ljust(64, b"\x00"), "config",
                             [CW, (CA_, True, False)], (3).to_bytes(2, "little") + CAUTH,
                             "AcctError"),
    "store_short_data": (_keys((CAUTH, True)).ljust(64, b"\x00"), "config",
                         [CW, (CA_, True, False)], b"\x01", "AcctError"),
    "store_no_accounts": (bytes(64), "config", [], _keys((CAUTH, True)), "AcctError"),
    "store_garbage_account": ((9).to_bytes(2, "little") + bytes(10), "config",
                              [CW, (CA_, True, False)], _keys((CAUTH, True)), "AcctError"),
}
COWNERS = {"config": tcfg.CONFIG_PROGRAM, "system": SYS}


def _run_config(p, name):
    data0, owner, iaccts, data, _ = CONFIG_SCENARIOS[name]
    vals = {CFG: p.ex.acct_encode(10**6, COWNERS[owner], data=data0),
            CAUTH: p.ex.acct_encode(10**9), COTHER: p.ex.acct_encode(10**9)}
    accounts = [p.ex.Account.from_value(k, vals[k]) for k in CKEYS]
    ctx = p.ex.TxnCtx(accounts=accounts, signer=[False] * 3, writable=[True] * 3)
    ia = [p.ex.InstrAccount(i, s, w) for i, s, w in iaccts]
    try:
        p.ex.Executor().execute_instr(ctx, tcfg.CONFIG_PROGRAM, ia, data)
        outcome = "ok"
    except Exception as e:  # the outcome's class is what both packages must share
        outcome = type(e).__name__
    return outcome, [a.to_value() for a in ctx.accounts], ctx.cu_used


@pytest.mark.parametrize("name", sorted(CONFIG_SCENARIOS))
def test_config_instruction_equals_jax(name):
    t = _run_config(PKGS["port"], name)
    assert t == _run_config(PKGS["jax"], name)
    assert t[0] == CONFIG_SCENARIOS[name][4]


@pytest.mark.parametrize("seed", range(2))
def test_config_keys_codec_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        keys = [(rng.bytes(32), bool(rng.integers(0, 2))) for _ in range(int(rng.integers(0, 4)))]
        payload = rng.bytes(int(rng.integers(0, 40)))
        blob = tcfg.build_keys(keys, payload)
        assert blob == jcfg.build_keys(keys, payload)
        assert tcfg.parse_keys(blob) == jcfg.parse_keys(blob) == (keys, payload)


# -- stake and config txns through execute_block ----------------------------------------------


def test_stake_and_config_block_equals_jax():
    from firedancer_tpu_torch.models.workload import program_stream

    ps = program_stream(n_v0=0, n_legacy=0, n_tables=1, table_len=4, n_stake_accts=16,
                        n_config_accts=16, n_ed25519=0, n_secp256k1=0, n_lookup_fail=0, n_alt=0)
    txns = [p_ for p_ in ps.stream if ps.kind[p_] in ("stake", "config")]
    out = {}
    for name, p in PKGS.items():
        funk = p.Funk()
        for pub, val in ps.genesis.items():
            funk.rec_insert(None, pub, val)
        res = p.rt.execute_block(funk, slot=ps.slot, txns=txns,
                                 parent_bank_hash=hashlib.sha256(b"parent").digest(), **p.kw)
        keys = sorted(funk.rec_keys(res.xid))
        out[name] = (res.bank_hash, [(r.status, r.fee) for r in res.results], res.waves,
                     [funk.rec_query(res.xid, k) for k in keys])
    assert out["port"] == out["jax"]
    assert {st for st, _ in out["port"][1]} == {trt.TXN_SUCCESS, trt.TXN_ERR_ACCT}
    secret = hashlib.sha256(b"programs" + b"stake-auth0").digest()
    assert ref.public_key(secret) in ps.genesis
