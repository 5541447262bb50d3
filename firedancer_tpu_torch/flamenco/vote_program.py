"""The vote program: the VoteState machine and every instruction the JAX
package handles (the port's counterpart of
firedancer_tpu/flamenco/vote_program.py, whole).

Instruction set (bincode u32 enum tag, VoteInstruction):

    0  InitializeAccount { node, authorized_voter, authorized_withdrawer,
                           commission }
    1  Authorize(Pubkey, VoteAuthorize)
    2  Vote { slots: Vec<u64>, hash, timestamp: Option<i64> }
    3  Withdraw(lamports)
    4  UpdateValidatorIdentity
    5  UpdateCommission(u8)
    6  VoteSwitch(Vote, Hash)           (proof hash unchecked, as Agave)
    7  AuthorizeChecked(VoteAuthorize)
    8  UpdateVoteState(VoteStateUpdate)
    9  UpdateVoteStateSwitch(VoteStateUpdate, Hash)
    14 TowerSync { lockouts, root, hash, timestamp, block_id }
    15 TowerSyncSwitch(TowerSync, Hash)

The rules, each named where it is implemented:
  - process_next_vote_slot: expired-lockout pop, root promotion at 31
    deep with its credit, lockout doubling (double_lockouts).
  - check_slots_are_valid: votes only for slots in the SlotHashes sysvar;
    the vote's hash must match the newest voted slot's entry.
  - timely vote credits: graded by latency (grace 2 slots, max 16).
  - authorized voter rotation takes effect the next epoch, one pending
    rotation at a time, the prior voter kept in a circular buffer.
  - withdraw: rent floor on a partial withdraw; a full drain only with no
    recent epoch credits; the state cleared.
  - commission increases only in the first half of the epoch.
  - process_new_vote_state (TowerSync/UpdateVoteState): monotonic slots,
    strictly decreasing confirmation counts, no root rollback, the last
    slot's hash checked against SlotHashes, credits for newly rooted
    slots.

The state is agave_state.VoteState, the on-chain bincode.  Failures raise
the port's InstrError, AcctError and FundsError (flamenco/executor.py,
flamenco/programs.py), which the runtime maps to txn statuses.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..protocol.txn import VOTE_PROGRAM
from . import types as T
from .agave_state import (
    LOCKOUT,
    LandedVote,
    Lockout,
    VoteState,
    vote_state_decode,
    vote_state_encode,
)
from .executor import InstrError
from .programs import AcctError, FundsError

MAX_LOCKOUT_HISTORY = 31
INITIAL_LOCKOUT = 2
VOTE_STATE_SIZE = 3762  # size_of::<VoteStateVersions>() — fixed account size
VOTE_CREDITS_GRACE_SLOTS = 2
VOTE_CREDITS_MAXIMUM_PER_SLOT = 16
MAX_EPOCH_CREDITS_HISTORY = 64

AUTHORIZE_VOTER = 0
AUTHORIZE_WITHDRAWER = 1


class VoteError(Exception):
    """Typed vote failure; the program wrapper maps it to InstrError."""


# -- instruction payload codecs ----------------------------------------------


@dataclass
class VoteInit:
    node_pubkey: bytes
    authorized_voter: bytes
    authorized_withdrawer: bytes
    commission: int


VOTE_INIT = T.StructCodec(
    VoteInit,
    ("node_pubkey", T.Pubkey),
    ("authorized_voter", T.Pubkey),
    ("authorized_withdrawer", T.Pubkey),
    ("commission", T.U8),
)


@dataclass
class VoteIx:
    slots: list
    hash: bytes
    timestamp: int | None


VOTE_IX = T.StructCodec(
    VoteIx,
    ("slots", T.Vec(T.U64, max_len=64)),
    ("hash", T.Hash32),
    ("timestamp", T.Option(T.I64)),
)


@dataclass
class VoteStateUpdate:
    lockouts: list  # [Lockout]
    root: int | None
    hash: bytes
    timestamp: int | None


VOTE_STATE_UPDATE = T.StructCodec(
    VoteStateUpdate,
    ("lockouts", T.Vec(LOCKOUT, max_len=64)),
    ("root", T.Option(T.U64)),
    ("hash", T.Hash32),
    ("timestamp", T.Option(T.I64)),
)


@dataclass
class TowerSync:
    lockouts: list  # [Lockout]
    root: int | None
    hash: bytes
    timestamp: int | None
    block_id: bytes


TOWER_SYNC = T.StructCodec(
    TowerSync,
    ("lockouts", T.Vec(LOCKOUT, max_len=64)),
    ("root", T.Option(T.U64)),
    ("hash", T.Hash32),
    ("timestamp", T.Option(T.I64)),
    ("block_id", T.Hash32),
)


def encode_vote_ix(slots: list[int], hash32: bytes,
                   timestamp: int | None = None) -> bytes:
    """Wire data for VoteInstruction::Vote (what voters emit)."""
    return T.U32.encode(2) + VOTE_IX.encode(VoteIx(slots, hash32, timestamp))


def encode_tower_sync_ix(lockouts: list[tuple[int, int]], root: int | None,
                         hash32: bytes, block_id: bytes = b"\x00" * 32,
                         timestamp: int | None = None) -> bytes:
    return T.U32.encode(14) + TOWER_SYNC.encode(TowerSync(
        [Lockout(s, c) for s, c in lockouts], root, hash32, timestamp,
        block_id))


def encode_initialize_ix(node: bytes, voter: bytes, withdrawer: bytes,
                         commission: int = 0) -> bytes:
    return T.U32.encode(0) + VOTE_INIT.encode(
        VoteInit(node, voter, withdrawer, commission))


# -- state machine ------------------------------------------------------------


def lockout_expired(lk: Lockout, next_slot: int) -> bool:
    """is_locked_out_at_slot inverted: lockout on `lk.slot` lasts
    2^confirmation_count slots."""
    return lk.slot + (INITIAL_LOCKOUT ** lk.confirmation_count) < next_slot


def credits_for_latency(latency: int) -> int:
    """Timely vote credits: full credit inside the grace window, then
    one fewer per extra slot of latency, floor 1 (vote_state credits_for
    _vote_at_index rule)."""
    if latency == 0:  # legacy votes with no recorded latency
        return 1
    if latency <= VOTE_CREDITS_GRACE_SLOTS:
        return VOTE_CREDITS_MAXIMUM_PER_SLOT
    return max(
        VOTE_CREDITS_MAXIMUM_PER_SLOT - (latency - VOTE_CREDITS_GRACE_SLOTS),
        1,
    )


def increment_credits(vs: VoteState, epoch: int, credits: int) -> None:
    if not vs.epoch_credits:
        vs.epoch_credits.append((epoch, 0, 0))
    elif epoch != vs.epoch_credits[-1][0]:
        _e, c, p = vs.epoch_credits[-1]
        if c != p:
            vs.epoch_credits.append((epoch, c, c))
        else:
            # the previous epoch earned NOTHING: replace its entry
            # rather than stacking zero-credit rows (Agave's encoding —
            # byte-parity with on-chain state demands it)
            vs.epoch_credits[-1] = (epoch, c, c)
        if len(vs.epoch_credits) > MAX_EPOCH_CREDITS_HISTORY:
            vs.epoch_credits.pop(0)
    e, c, p = vs.epoch_credits[-1]
    vs.epoch_credits[-1] = (e, c + credits, p)


def double_lockouts(vs: VoteState) -> None:
    """Every vote deeper in the stack than its confirmation count gets
    its confirmation count bumped — the lockout-doubling rule."""
    depth = len(vs.votes)
    for i, lv in enumerate(vs.votes):
        if depth > i + lv.lockout.confirmation_count:
            lv.lockout.confirmation_count += 1


def pop_expired_votes(vs: VoteState, next_slot: int) -> None:
    while vs.votes and lockout_expired(vs.votes[-1].lockout, next_slot):
        vs.votes.pop()


def process_next_vote_slot(vs: VoteState, next_slot: int, epoch: int,
                           current_slot: int) -> None:
    """The heart of the program: one new vote slot onto the tower."""
    if vs.votes and vs.votes[-1].lockout.slot >= next_slot:
        return
    pop_expired_votes(vs, next_slot)
    latency = max(0, current_slot - next_slot) if current_slot else 0
    lv = LandedVote(min(latency, 255), Lockout(next_slot, 1))
    if len(vs.votes) == MAX_LOCKOUT_HISTORY:
        rooted = vs.votes.pop(0)
        vs.root_slot = rooted.lockout.slot
        increment_credits(vs, epoch, credits_for_latency(rooted.latency))
    vs.votes.append(lv)
    double_lockouts(vs)


def check_slots_are_valid(vs: VoteState, slots: list[int], vote_hash: bytes,
                          slot_hashes: list[tuple[int, bytes]]) -> list[int]:
    """Filter to slots newer than the last vote AND present in
    SlotHashes; the vote's hash must match the newest voted slot's
    entry.  Returns the accepted slots (VoteError on none/mismatch)."""
    sh = dict(slot_hashes)
    last = vs.votes[-1].lockout.slot if vs.votes else -1
    accepted = [s for s in slots if s > last and s in sh]
    if not accepted:
        raise VoteError("VotesTooOldAllFiltered/SlotsMismatch")
    if sh[accepted[-1]] != vote_hash:
        raise VoteError("SlotHashMismatch")
    return accepted


def process_vote(vs: VoteState, vote: VoteIx,
                 slot_hashes: list[tuple[int, bytes]],
                 epoch: int, current_slot: int) -> None:
    if not vote.slots:
        raise VoteError("EmptySlots")
    for s in check_slots_are_valid(vs, vote.slots, vote.hash, slot_hashes):
        process_next_vote_slot(vs, s, epoch, current_slot)
    if vote.timestamp is not None:
        slot = vote.slots[-1]
        _check_and_set_timestamp(vs, slot, vote.timestamp)


def _check_and_set_timestamp(vs: VoteState, slot: int, ts: int) -> None:
    """process_timestamp: monotone in slot and time; the same slot may
    only re-assert the identical timestamp."""
    lt = vs.last_timestamp
    if (
        slot < lt.slot
        or ts < lt.timestamp
        or (slot == lt.slot and (slot, ts) != (lt.slot, lt.timestamp)
            and lt.slot != 0)
    ):
        # same slot may only RE-ASSERT the identical timestamp
        raise VoteError("TimestampTooOld")
    lt.slot = slot
    lt.timestamp = ts


def process_new_vote_state(
    vs: VoteState,
    new_lockouts: list[Lockout],
    new_root: int | None,
    vote_hash: bytes,
    slot_hashes: list[tuple[int, bytes]],
    epoch: int,
    current_slot: int,
) -> None:
    """TowerSync / UpdateVoteState: replace the tower wholesale after
    validating its internal structure and consistency with this fork."""
    if not new_lockouts:
        raise VoteError("EmptySlots")
    if len(new_lockouts) > MAX_LOCKOUT_HISTORY:
        raise VoteError("TooManyVotes")
    if vs.votes and new_lockouts[-1].slot <= vs.votes[-1].lockout.slot:
        # a new state may never REWIND the last voted slot — else the
        # voter could shrink its tower and re-vote 16..30 on another
        # fork, breaking lockout safety (Agave's VoteTooOld)
        raise VoteError("VoteTooOld")
    if new_root is not None and vs.root_slot is not None \
            and new_root < vs.root_slot:
        raise VoteError("RootRollBack")
    if new_root is None and vs.root_slot is not None:
        raise VoteError("RootRollBack")
    for i, lk in enumerate(new_lockouts):
        if not 1 <= lk.confirmation_count <= MAX_LOCKOUT_HISTORY:
            raise VoteError("ConfirmationOutOfBounds")
        if new_root is not None and lk.slot <= new_root:
            raise VoteError("SlotSmallerThanRoot")
        if i > 0:
            prev = new_lockouts[i - 1]
            if lk.slot <= prev.slot:
                raise VoteError("SlotsNotOrdered")
            if lk.confirmation_count >= prev.confirmation_count:
                raise VoteError("ConfirmationsNotOrdered")
    sh = dict(slot_hashes)
    last_slot = new_lockouts[-1].slot
    if last_slot not in sh:
        raise VoteError("SlotsMismatch")
    if sh[last_slot] != vote_hash:
        raise VoteError("SlotHashMismatch")
    # credits for slots the new state roots that the old one hadn't:
    # every old vote at or below the new root earns its landing credit
    if new_root is not None:
        old_root = vs.root_slot if vs.root_slot is not None else -1
        for lv in vs.votes:
            if old_root < lv.lockout.slot <= new_root:
                increment_credits(vs, epoch,
                                  credits_for_latency(lv.latency))
    # carry landing latencies for slots surviving into the new tower
    latency_by_slot = {lv.lockout.slot: lv.latency for lv in vs.votes}
    vs.votes = [
        LandedVote(
            latency_by_slot.get(
                lk.slot,
                min(max(0, current_slot - lk.slot), 255) if current_slot
                else 0,
            ),
            lk,
        )
        for lk in new_lockouts
    ]
    vs.root_slot = new_root


def set_new_authorized_voter(vs: VoteState, new_voter: bytes,
                             current_epoch: int, target_epoch: int) -> None:
    """Rotation lands at `target_epoch` (next): one pending rotation at
    a time; the outgoing voter is recorded in the prior-voters circular
    buffer."""
    if any(e > current_epoch for e in vs.authorized_voters):
        raise VoteError("TooSoonToReauthorize")
    current = vs.authorized_voter_for(current_epoch)
    if current == new_voter:
        return
    pv = vs.prior_voters
    if current is not None:
        epoch_of_last_rotation = max(
            (e for e in vs.authorized_voters if e <= current_epoch),
            default=0,
        )
        pv.idx = (pv.idx + 1) % 32
        pv.buf[pv.idx] = (current, epoch_of_last_rotation, target_epoch)
        pv.is_empty = False
    # drop map entries older than the latest one still <= current_epoch
    keep_from = max((e for e in vs.authorized_voters if e <= current_epoch),
                    default=None)
    vs.authorized_voters = {
        e: v for e, v in vs.authorized_voters.items()
        if keep_from is None or e >= keep_from
    }
    vs.authorized_voters[target_epoch] = new_voter


# -- the program entry --------------------------------------------------------


def _clock(ctx):
    blob = ctx.sysvars.get("clock")
    if not blob:
        raise VoteError("clock sysvar unavailable")
    return T.CLOCK.loads(blob)


def _slot_hashes(ctx) -> list[tuple[int, bytes]]:
    blob = ctx.sysvars.get("slot_hashes")
    if not blob:
        return []
    return [(e.slot, e.hash) for e in T.SLOT_HASHES.loads(blob)]


def _state_load(acct) -> VoteState | None:
    data = bytes(acct.data)
    if not data.strip(b"\x00"):
        return None  # uninitialized (all zero — V0_23_5 default state)
    return vote_state_decode(data)


def _state_store(acct, vs: VoteState) -> None:
    blob = vote_state_encode(vs)
    if len(blob) > len(acct.data):
        # the account's space is FIXED at creation: set_state must never
        # grow it (no realloc / rent re-check path here, as Agave)
        raise VoteError("vote state overflows the account data size")
    acct.data = bytearray(blob.ljust(len(acct.data), b"\x00"))


def vote_program(executor, ctx, program_id, iaccts, data, *,
                 pda_signers):
    """Native-program entry (executor registry signature)."""
    try:
        tag, off = T.U32.decode(data, 0)
    except T.CodecError:
        raise InstrError("vote: truncated instruction")

    if not iaccts:
        raise AcctError("vote: missing vote account")
    vote_acct = ctx.accounts[iaccts[0].txn_idx]
    if vote_acct.owner != VOTE_PROGRAM:
        raise AcctError("vote account not owned by the vote program")
    if not iaccts[0].is_writable:
        raise AcctError("vote account not writable")

    def signers() -> set[bytes]:
        out = set(pda_signers)
        for ia in iaccts:
            if ia.is_signer:
                out.add(ctx.accounts[ia.txn_idx].key)
        return out

    def require_sig(pk: bytes | None, what: str) -> None:
        if pk is None or pk not in signers():
            raise AcctError(f"vote: missing {what} signature")

    try:
        clock = _clock(ctx)
        if tag == 0:  # InitializeAccount
            init, _ = VOTE_INIT.decode(data, off)
            if len(vote_acct.data) != VOTE_STATE_SIZE:
                raise VoteError("vote account has wrong data size")
            if bytes(vote_acct.data).strip(b"\x00"):
                raise VoteError("vote account already initialized")
            # the node (validator identity) must sign account creation
            require_sig(init.node_pubkey, "node")
            vs = VoteState(
                node_pubkey=init.node_pubkey,
                authorized_withdrawer=init.authorized_withdrawer,
                commission=init.commission,
                authorized_voters={clock.epoch: init.authorized_voter},
            )
            _state_store(vote_acct, vs)
            return

        vs = _state_load(vote_acct)
        if vs is None:
            raise VoteError("vote account uninitialized")

        if tag in (2, 6):  # Vote / VoteSwitch
            vote, _ = VOTE_IX.decode(data, off)
            require_sig(vs.authorized_voter_for(clock.epoch),
                        "authorized-voter")
            process_vote(vs, vote, _slot_hashes(ctx), clock.epoch,
                         clock.slot)
        elif tag in (8, 9, 14, 15):  # UpdateVoteState / TowerSync (+Switch)
            if tag in (8, 9):
                upd, _ = VOTE_STATE_UPDATE.decode(data, off)
            else:
                upd, _ = TOWER_SYNC.decode(data, off)
            require_sig(vs.authorized_voter_for(clock.epoch),
                        "authorized-voter")
            process_new_vote_state(vs, upd.lockouts, upd.root, upd.hash,
                                   _slot_hashes(ctx), clock.epoch,
                                   clock.slot)
            if upd.timestamp is not None and upd.lockouts:
                _check_and_set_timestamp(vs, upd.lockouts[-1].slot,
                                         upd.timestamp)
        elif tag == 1:  # Authorize(new_pubkey, which)
            new_pk, o2 = T.Pubkey.decode(data, off)
            which, _ = T.U32.decode(data, o2)
            _authorize(vs, new_pk, which, clock, require_sig)
        elif tag == 7:  # AuthorizeChecked: new authority is account 3 + signs
            which, _ = T.U32.decode(data, off)
            if len(iaccts) < 4:
                raise AcctError("vote authorize-checked needs 4 accounts")
            new_acct = ctx.accounts[iaccts[3].txn_idx]
            if not iaccts[3].is_signer:
                raise AcctError("vote: new authority must sign (checked)")
            _authorize(vs, new_acct.key, which, clock, require_sig)
        elif tag == 3:  # Withdraw(lamports)
            lamports, _ = T.U64.decode(data, off)
            if len(iaccts) < 2:
                raise AcctError("vote withdraw needs recipient")
            if not iaccts[1].is_writable:
                raise AcctError("vote withdraw recipient not writable")
            recipient = ctx.accounts[iaccts[1].txn_idx]
            require_sig(vs.authorized_withdrawer, "withdrawer")
            _withdraw(vote_acct, vs, recipient, lamports, clock, ctx)
            return  # _withdraw stores/clears state itself
        elif tag == 4:  # UpdateValidatorIdentity
            if len(iaccts) < 2:
                raise AcctError("vote identity update needs node account")
            node = ctx.accounts[iaccts[1].txn_idx]
            if not iaccts[1].is_signer:
                raise AcctError("vote: new node must sign")
            require_sig(vs.authorized_withdrawer, "withdrawer")
            vs.node_pubkey = node.key
        elif tag == 5:  # UpdateCommission(u8)
            new_commission, _ = T.U8.decode(data, off)
            require_sig(vs.authorized_withdrawer, "withdrawer")
            if new_commission > vs.commission:
                # increases land only in the first half of the epoch, so
                # a validator cannot raise its cut right before rewards
                sched = T.EPOCH_SCHEDULE.loads(ctx.sysvars["epoch_schedule"]) \
                    if ctx.sysvars.get("epoch_schedule") else T.EpochSchedule()
                try:
                    # epoch-relative index honoring first_normal_slot
                    _e, into_epoch = T.epoch_of_slot(sched, clock.slot)
                except T.CodecError:  # warmup epochs: modulo fallback
                    into_epoch = clock.slot % max(sched.slots_per_epoch, 1)
                if into_epoch > sched.slots_per_epoch // 2:
                    raise VoteError("CommissionUpdateTooLate")
            vs.commission = new_commission
        else:
            raise InstrError(f"vote: unsupported instruction {tag}")
        _state_store(vote_acct, vs)
    except VoteError as e:
        raise InstrError(f"vote: {e}")
    except T.CodecError as e:
        raise InstrError(f"vote: malformed instruction ({e})")


def _authorize(vs: VoteState, new_pk: bytes, which: int, clock,
               require_sig) -> None:
    if which == AUTHORIZE_VOTER:
        # current voter OR the withdrawer may rotate the voter
        current = vs.authorized_voter_for(clock.epoch)
        try:
            require_sig(current, "authorized-voter")
        except AcctError:
            require_sig(vs.authorized_withdrawer, "withdrawer")
        set_new_authorized_voter(vs, new_pk, clock.epoch, clock.epoch + 1)
    elif which == AUTHORIZE_WITHDRAWER:
        require_sig(vs.authorized_withdrawer, "withdrawer")
        vs.authorized_withdrawer = new_pk
    else:
        raise VoteError("bad VoteAuthorize")


def _withdraw(vote_acct, vs: VoteState, recipient, lamports: int, clock,
              ctx) -> None:
    if lamports > vote_acct.lamports:
        raise FundsError("vote withdraw exceeds balance")
    remaining = vote_acct.lamports - lamports
    if remaining == 0:
        # closing an ACTIVE vote account is rejected: credits earned in
        # this or the previous epoch mean stakes still reference it
        if any(e >= clock.epoch - 1 for e, _c, _p in vs.epoch_credits):
            raise VoteError("ActiveVoteAccountClose")
        vote_acct.data = bytearray(len(vote_acct.data))  # deinitialize
    else:
        rent_blob = ctx.sysvars.get("rent")
        rent = T.RENT.loads(rent_blob) if rent_blob else T.Rent()
        floor = T.rent_exempt_minimum(rent, len(vote_acct.data))
        if remaining < floor:
            raise FundsError("vote withdraw below rent-exempt floor")
        _state_store(vote_acct, vs)
    vote_acct.lamports = remaining
    recipient.lamports += lamports
