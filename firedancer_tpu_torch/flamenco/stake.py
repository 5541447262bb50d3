"""Stake program and epoch stakes and rewards (the port's copy of
firedancer_tpu/flamenco/stake.py).

Stake account data layout (this framework's own fixed encoding, not
Agave's StakeStateV2, which flamenco/agave_state.py decodes):

    u32 state      0 = uninitialized, 1 = initialized, 2 = delegated
    32B staker     authority allowed to delegate/deactivate
    32B withdrawer authority allowed to withdraw
    32B voter      vote account delegated to (state 2)
    u64 stake      delegated lamports
    u64 activation_epoch    (state 2; UINT64_MAX = not yet)
    u64 deactivation_epoch  (UINT64_MAX = active)

Activation and deactivation follow a warmup/cooldown ramp: a quarter of
the delegation (de)activates per epoch boundary; `effective_stake` walks
the epochs from activation to the target epoch with integer arithmetic.

Rewards: `epoch_rewards` distributes an inflation pot over (stake x
vote-credits) points: each stake account earns pot * its_points /
total_points, paid onto the stake account and compounded into the
delegation; the partitioned form pays one partition a slot.

The program id is the JAX package's own constant, b"Stake11111" +
bytes(22).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import types as T
from .executor import acct_decode, acct_encode
from .programs import AcctError, FundsError, _u32, _u64

STAKE_PROGRAM = b"Stake11111" + bytes(22)

U64_MAX = (1 << 64) - 1
WARMUP_DIV = 4  # a quarter of delegated stake (de)activates per epoch

STATE_UNINIT = 0
STATE_INIT = 1
STATE_DELEGATED = 2

_DATA_LEN = 4 + 32 * 3 + 8 * 3


@dataclass
class StakeState:
    state: int = STATE_UNINIT
    staker: bytes = bytes(32)
    withdrawer: bytes = bytes(32)
    voter: bytes = bytes(32)
    stake: int = 0
    activation_epoch: int = U64_MAX
    deactivation_epoch: int = U64_MAX

    def encode(self) -> bytes:
        return (
            self.state.to_bytes(4, "little")
            + self.staker
            + self.withdrawer
            + self.voter
            + self.stake.to_bytes(8, "little")
            + self.activation_epoch.to_bytes(8, "little")
            + self.deactivation_epoch.to_bytes(8, "little")
        )

    @classmethod
    def decode(cls, data: bytes) -> "StakeState":
        if len(data) < _DATA_LEN:
            return cls()
        return cls(
            state=_u32(data),
            staker=data[4:36],
            withdrawer=data[36:68],
            voter=data[68:100],
            stake=_u64(data[100:]),
            activation_epoch=_u64(data[108:]),
            deactivation_epoch=_u64(data[116:]),
        )


def effective_stake(st: StakeState, epoch: int) -> int:
    """Delegated lamports counted at `epoch`, after the warmup/cooldown
    ramp.  Full stake takes 1/WARMUP_RATE epoch boundaries.  Integer
    arithmetic throughout — this value feeds consensus (leader schedule,
    rewards), so float rounding above 2^53 lamports is unacceptable."""
    if st.state != STATE_DELEGATED or epoch < st.activation_epoch:
        return 0
    # warmup: a quarter of the target per boundary crossed since activation
    boundaries = epoch - st.activation_epoch
    eff = min(st.stake, st.stake * boundaries // WARMUP_DIV)
    if st.deactivation_epoch != U64_MAX and epoch >= st.deactivation_epoch:
        gone = st.stake * (epoch - st.deactivation_epoch) // WARMUP_DIV
        eff = max(0, eff - gone)
    return eff


def locked_stake(st: StakeState, epoch: int) -> int:
    """Lamports a Withdraw may NOT touch: the whole delegation while it
    is active or warming up (warming stake is committed even though not
    yet effective — otherwise freshly delegated lamports could be
    withdrawn leaving phantom stake in the epoch snapshots), ramping to
    zero through cooldown after deactivation."""
    if st.state != STATE_DELEGATED:
        return 0
    if st.deactivation_epoch == U64_MAX or epoch < st.deactivation_epoch:
        return st.stake
    released = st.stake * (epoch - st.deactivation_epoch) // WARMUP_DIV
    return max(0, st.stake - released)


# -- the stake native program -------------------------------------------------
# instruction tags: 0 Initialize{staker,withdrawer} | 1 Delegate |
# 2 Deactivate | 3 Withdraw{lamports} | 4 Split{lamports}
#
# Epochs come from the Clock sysvar (ctx.sysvars["clock"]), never from
# instruction data.  An attacker-controlled epoch would let a withdrawer skip the
# warmup/cooldown ramp entirely (pass a far-future epoch so locked_stake
# ramps to zero) or make stake instantly effective.


def _clock_epoch(ctx) -> int:
    """Current epoch per the Clock sysvar.  Fails CLOSED: a context without
    a clock cannot run time-sensitive stake instructions — defaulting to
    epoch 0 would re-open the cooldown-skip (deactivation_epoch=0 followed
    by a real-clock withdraw drains an actively-cooling delegation)."""
    blob = ctx.sysvars.get("clock")
    if not blob:
        raise AcctError("stake instruction requires the clock sysvar")
    clock, _ = T.CLOCK.decode(blob, 0)
    return clock.epoch


def stake_program(executor, ctx, program_id, iaccts, data, *, pda_signers):
    if len(data) < 4:
        return
    tag = _u32(data)

    def acct(i, *, owned: bool = True):
        if i >= len(iaccts):
            raise AcctError(f"stake instr needs account {i}")
        a = ctx.accounts[iaccts[i].txn_idx]
        if owned and a.owner != STAKE_PROGRAM:
            # the owner-may-modify/debit rule: the stake program only
            # touches its own accounts (blocks draining foreign accounts
            # through the uninitialized-state paths)
            raise AcctError(f"account {i} not owned by the stake program")
        return a

    def signed_by(key: bytes) -> bool:
        for ia in iaccts:
            if ctx.accounts[ia.txn_idx].key == key and (
                ia.is_signer
                or ctx.accounts[ia.txn_idx].key in pda_signers
            ):
                return True
        return False

    def need_writable(i):
        if not iaccts[i].is_writable:
            raise AcctError(f"stake account {i} not writable")

    if tag == 0:  # Initialize { staker 32 | withdrawer 32 }
        if len(data) < 4 + 64:
            raise AcctError("malformed stake initialize")
        a = acct(0)
        need_writable(0)
        st = StakeState.decode(bytes(a.data))
        if st.state != STATE_UNINIT:
            raise AcctError("stake account already initialized")
        if len(a.data) < _DATA_LEN:
            raise AcctError("stake account too small")
        st = StakeState(
            state=STATE_INIT, staker=data[4:36], withdrawer=data[36:68]
        )
        a.data[:_DATA_LEN] = st.encode()
    elif tag == 1:  # Delegate; accounts: [stake, vote]
        a, vote = acct(0), acct(1, owned=False)
        need_writable(0)
        st = StakeState.decode(bytes(a.data))
        if st.state == STATE_UNINIT:
            raise AcctError("delegate of uninitialized stake")
        if not signed_by(st.staker):
            raise AcctError("delegate missing staker signature")
        epoch = _clock_epoch(ctx)
        st.state = STATE_DELEGATED
        st.voter = vote.key
        st.stake = a.lamports  # whole balance delegates (rent exempt 0 here)
        st.activation_epoch = epoch
        st.deactivation_epoch = U64_MAX
        a.data[:_DATA_LEN] = st.encode()
    elif tag == 2:  # Deactivate
        a = acct(0)
        need_writable(0)
        st = StakeState.decode(bytes(a.data))
        if st.state != STATE_DELEGATED:
            raise AcctError("deactivate of undelegated stake")
        if not signed_by(st.staker):
            raise AcctError("deactivate missing staker signature")
        st.deactivation_epoch = _clock_epoch(ctx)
        a.data[:_DATA_LEN] = st.encode()
    elif tag == 3:  # Withdraw { lamports u64 }; [stake, dest]
        if len(data) < 12:
            raise AcctError("malformed withdraw")
        lamports = _u64(data[4:])
        a, dest = acct(0), acct(1, owned=False)
        need_writable(0)
        need_writable(1)
        st = StakeState.decode(bytes(a.data))
        if st.state == STATE_UNINIT:
            # an uninitialized stake account withdraws under its OWN key
            if not signed_by(a.key):
                raise AcctError("withdraw missing stake-account signature")
        elif not signed_by(st.withdrawer):
            raise AcctError("withdraw missing withdrawer signature")
        locked = locked_stake(st, _clock_epoch(ctx)) \
            if st.state == STATE_DELEGATED else 0
        if a.lamports - locked < lamports:
            raise FundsError(
                f"withdraw {lamports} exceeds free balance "
                f"({a.lamports} - {locked} locked)"
            )
        if a.key == dest.key:
            return
        a.lamports -= lamports
        dest.lamports += lamports
    elif tag == 4:  # Split { lamports u64 }; [stake, new_stake]
        if len(data) < 12:
            raise AcctError("malformed split")
        lamports = _u64(data[4:])
        a, new = acct(0), acct(1)
        need_writable(0)
        need_writable(1)
        st = StakeState.decode(bytes(a.data))
        if st.state != STATE_DELEGATED:
            raise AcctError("split of undelegated stake")
        if not signed_by(st.staker):
            raise AcctError("split missing staker signature")
        if lamports > st.stake or lamports > a.lamports:
            raise FundsError("split larger than delegation")
        if len(new.data) < _DATA_LEN:
            raise AcctError("split target too small")
        nst = StakeState.decode(bytes(new.data))
        if nst.state != STATE_UNINIT:
            raise AcctError("split target already in use")
        st.stake -= lamports
        a.lamports -= lamports
        a.data[:_DATA_LEN] = st.encode()
        new.lamports += lamports
        nst = StakeState(
            state=STATE_DELEGATED, staker=st.staker,
            withdrawer=st.withdrawer, voter=st.voter, stake=lamports,
            activation_epoch=st.activation_epoch,
            deactivation_epoch=st.deactivation_epoch,
        )
        new.data[:_DATA_LEN] = nst.encode()
    # other tags: no-op


# -- epoch stakes + rewards ---------------------------------------------------


@dataclass
class StakeEntry:
    stake_key: bytes
    state: StakeState


def collect_stakes(entries: list[StakeEntry], epoch: int) -> dict[bytes, int]:
    """voter pubkey -> total effective stake at `epoch` (the per-epoch
    snapshot that feeds the leader schedule)."""
    out: dict[bytes, int] = {}
    for e in entries:
        eff = effective_stake(e.state, epoch)
        if eff > 0:
            out[e.state.voter] = out.get(e.state.voter, 0) + eff
    return out


def epoch_rewards(
    entries: list[StakeEntry],
    credits: dict[bytes, int],
    *,
    epoch: int,
    pot: int,
) -> dict[bytes, int]:
    """Distribute `pot` lamports over stake accounts by points =
    effective_stake x voter credits.
    Returns stake_key -> reward; remainder lamports stay undistributed
    (burned), matching the integer-division convention."""
    points: dict[bytes, int] = {}
    total = 0
    for e in entries:
        p = effective_stake(e.state, epoch) * credits.get(e.state.voter, 0)
        if p > 0:
            points[e.stake_key] = p
            total += p
    if total == 0:
        return {}
    return {k: pot * p // total for k, p in points.items()}


def apply_rewards(accounts: dict[bytes, "object"], rewards: dict[bytes, int]):
    """Pay rewards onto stake accounts, compounding the delegation (the
    auto-compound rule: a delegated stake's reward joins its stake)."""
    for key, amount in rewards.items():
        a = accounts[key]
        a.lamports += amount
        st = StakeState.decode(bytes(a.data))
        if st.state == STATE_DELEGATED:
            st.stake += amount
            a.data[:_DATA_LEN] = st.encode()


# -- partitioned rewards distribution -----------------------------------------
# Epoch rewards pay out over the first slots of the new epoch instead of one
# slot-boundary write burst (Agave's epoch_rewards partitioning).
# Accounts hash into partitions; partition i pays out in slot
# epoch_start + 1 + i; the EpochRewards sysvar stays `active` until the
# last partition lands.

PARTITION_TARGET_ACCOUNTS = 4096  # Agave's per-partition sizing target


def reward_partition_count(n_accounts: int) -> int:
    return max(1, (n_accounts + PARTITION_TARGET_ACCOUNTS - 1)
               // PARTITION_TARGET_ACCOUNTS)


def reward_partition_of(stake_key: bytes, n_partitions: int,
                        parent_blockhash: bytes) -> int:
    """Deterministic partition assignment: hash(address, seed) — every
    validator derives the same schedule from the epoch-boundary state."""
    digest = hashlib.sha256(b"epoch-rewards-partition:" + parent_blockhash
                        + stake_key).digest()
    return int.from_bytes(digest[:8], "little") % n_partitions


def partition_rewards(
    rewards: dict[bytes, int],
    parent_blockhash: bytes,
) -> list[dict[bytes, int]]:
    """Split a computed reward set into per-slot payout partitions."""
    n = reward_partition_count(len(rewards))
    parts: list[dict[bytes, int]] = [{} for _ in range(n)]
    for key, amount in rewards.items():
        parts[reward_partition_of(key, n, parent_blockhash)][key] = amount
    return parts


def epoch_rewards_sysvar(
    *,
    distribution_starting_block_height: int,
    num_partitions: int,
    parent_blockhash: bytes,
    total_points: int,
    total_rewards: int,
    distributed_rewards: int,
    active: bool,
) -> bytes:
    """The EpochRewards sysvar blob (the layout runtime.default_sysvars
    zero-fills when no distribution is in flight)."""
    return (
        distribution_starting_block_height.to_bytes(8, "little")
        + num_partitions.to_bytes(8, "little")
        + parent_blockhash
        + total_points.to_bytes(16, "little")
        + total_rewards.to_bytes(8, "little")
        + distributed_rewards.to_bytes(8, "little")
        + (b"\x01" if active else b"\x00")
    )


def distribute_reward_partition(
    funk,
    xid: bytes | None,
    partition: dict[bytes, int],
) -> int:
    """Pay out ONE partition onto funk accounts with the compounding
    rule — slot epoch_start+1+i pays exactly partitions[i], so calling
    once per slot can never double-pay.  Accounts that vanished between
    reward computation and payout are SKIPPED (paying a missing record
    would mint lamports into a fresh system account).  Returns lamports
    paid."""
    paid = 0
    for key, amount in partition.items():
        val = funk.rec_query(xid, key)
        if val is None:
            continue  # closed since the epoch boundary: no destination
        lam, owner, ex, data = acct_decode(val)
        data = bytearray(data)
        if len(data) >= _DATA_LEN:
            st = StakeState.decode(bytes(data))
            if st.state == STATE_DELEGATED:
                st.stake += amount
                data[:_DATA_LEN] = st.encode()
        funk.rec_insert(xid, key,
                        acct_encode(lam + amount, owner, ex, bytes(data)))
        paid += amount
    return paid
