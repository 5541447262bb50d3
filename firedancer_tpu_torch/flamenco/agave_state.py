"""Agave on-chain account state (the port's counterpart of
firedancer_tpu/flamenco/agave_state.py): vote accounts and stake accounts.

The exact bincode layout Agave stores in a vote account, which the vote
program (flamenco/vote_program.py) reads and writes:

  VoteStateVersions  = enum { 0: V0_23_5, 1: V1_14_11, 2: Current }
  VoteState(Current) = node_pubkey | authorized_withdrawer | commission
      u8 | votes VecDeque<LandedVote{latency u8, Lockout{slot u64,
      conf u32}}> | root Option<u64> | authorized_voters BTreeMap<u64,
      Pubkey> | prior_voters CircBuf{[(Pubkey,u64,u64); 32], idx u64,
      is_empty bool} | epoch_credits Vec<(u64,u64,u64)> |
      last_timestamp {slot u64, ts i64}

Encoding writes the current version; decoding accepts all three and
upgrades the older layouts to the current view.

The stake half: StakeStateV2 = enum { 0: Uninitialized, 1: Initialized
(Meta), 2: Stake (Meta, Stake{Delegation, credits_observed}, flags u8),
3: RewardsPool }, with Meta = rent_exempt_reserve u64 | Authorized{staker,
withdrawer} | Lockup{unix_timestamp i64, epoch u64, custodian}, and
Delegation = voter | stake u64 | activation_epoch u64 |
deactivation_epoch u64 | warmup_cooldown_rate f64.  `to_internal_stake`
maps it onto flamenco/stake.py's compact view, and `vote_account_summary`
reads what consensus takes from a vote account.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import types as T

U64_MAX = (1 << 64) - 1


@dataclass
class Lockout:
    slot: int = 0
    confirmation_count: int = 0


LOCKOUT = T.StructCodec(
    Lockout, ("slot", T.U64), ("confirmation_count", T.U32),
)


@dataclass
class LandedVote:
    latency: int = 0
    lockout: Lockout = field(default_factory=Lockout)


LANDED_VOTE = T.StructCodec(
    LandedVote, ("latency", T.U8), ("lockout", LOCKOUT),
)


class _BTreeMapU64Pubkey(T.Codec):
    """BTreeMap<u64, Pubkey>: u64 count + sorted (u64, 32B) pairs."""

    def encode(self, v: dict) -> bytes:
        out = T.U64.encode(len(v))
        for k in sorted(v):
            out += T.U64.encode(k) + bytes(v[k])
        return out

    def decode(self, buf, off=0):
        n, off = T.U64.decode(buf, off)
        if n > 1024:
            raise T.CodecError(f"authorized_voters map too large ({n})")
        out = {}
        for _ in range(n):
            k, off = T.U64.decode(buf, off)
            pk, off = T.Pubkey.decode(buf, off)
            out[k] = pk
        return out, off


@dataclass
class PriorVoters:
    buf: list = field(default_factory=lambda: [(bytes(32), 0, 0)] * 32)
    idx: int = 31
    is_empty: bool = True


class _PriorVotersCodec(T.Codec):
    def encode(self, v: PriorVoters) -> bytes:
        out = b""
        for pk, start, end in v.buf:
            out += bytes(pk) + T.U64.encode(start) + T.U64.encode(end)
        return out + T.U64.encode(v.idx) + T.Bool.encode(v.is_empty)

    def decode(self, buf, off=0):
        entries = []
        for _ in range(32):
            pk, off = T.Pubkey.decode(buf, off)
            a, off = T.U64.decode(buf, off)
            b, off = T.U64.decode(buf, off)
            entries.append((pk, a, b))
        idx, off = T.U64.decode(buf, off)
        empty, off = T.Bool.decode(buf, off)
        return PriorVoters(entries, idx, empty), off


@dataclass
class BlockTimestamp:
    slot: int = 0
    timestamp: int = 0


BLOCK_TIMESTAMP = T.StructCodec(
    BlockTimestamp, ("slot", T.U64), ("timestamp", T.I64),
)


class _EpochCredits(T.Codec):
    """Vec<(epoch u64, credits u64, prev_credits u64)>."""

    def encode(self, v: list) -> bytes:
        out = T.U64.encode(len(v))
        for epoch, credits, prev in v:
            out += T.U64.encode(epoch) + T.U64.encode(credits) \
                + T.U64.encode(prev)
        return out

    def decode(self, buf, off=0):
        n, off = T.U64.decode(buf, off)
        if n > 4096:
            raise T.CodecError(f"epoch_credits too large ({n})")
        out = []
        for _ in range(n):
            e, off = T.U64.decode(buf, off)
            c, off = T.U64.decode(buf, off)
            p, off = T.U64.decode(buf, off)
            out.append((e, c, p))
        return out, off


@dataclass
class VoteState:
    node_pubkey: bytes = bytes(32)
    authorized_withdrawer: bytes = bytes(32)
    commission: int = 0
    votes: list = field(default_factory=list)  # [LandedVote]
    root_slot: int | None = None
    authorized_voters: dict = field(default_factory=dict)  # epoch -> pk
    prior_voters: PriorVoters = field(default_factory=PriorVoters)
    epoch_credits: list = field(default_factory=list)
    last_timestamp: BlockTimestamp = field(default_factory=BlockTimestamp)

    def authorized_voter_for(self, epoch: int) -> bytes | None:
        """The voter authorized at `epoch`: the entry with the greatest
        key <= epoch (Agave's AuthorizedVoters::get_authorized_voter)."""
        best = None
        for e in sorted(self.authorized_voters):
            if e <= epoch:
                best = self.authorized_voters[e]
        return best

    def credits(self) -> int:
        return self.epoch_credits[-1][1] if self.epoch_credits else 0


_VOTE_STATE_BODY = T.StructCodec(
    VoteState,
    ("node_pubkey", T.Pubkey),
    ("authorized_withdrawer", T.Pubkey),
    ("commission", T.U8),
    ("votes", T.Vec(LANDED_VOTE, max_len=64)),
    ("root_slot", T.Option(T.U64)),
    ("authorized_voters", _BTreeMapU64Pubkey()),
    ("prior_voters", _PriorVotersCodec()),
    ("epoch_credits", _EpochCredits()),
    ("last_timestamp", BLOCK_TIMESTAMP),
)


# VoteState1_14_11: identical body except votes is VecDeque<Lockout>
# (no latency byte).  Still present in real cluster snapshots, so the
# decoder must accept it (vote_state_versions converters in the
# reference do the same upgrade-on-read).
_VOTE_STATE_BODY_1_14_11 = T.StructCodec(
    VoteState,
    ("node_pubkey", T.Pubkey),
    ("authorized_withdrawer", T.Pubkey),
    ("commission", T.U8),
    ("votes", T.Vec(LOCKOUT, max_len=64)),
    ("root_slot", T.Option(T.U64)),
    ("authorized_voters", _BTreeMapU64Pubkey()),
    ("prior_voters", _PriorVotersCodec()),
    ("epoch_credits", _EpochCredits()),
    ("last_timestamp", BLOCK_TIMESTAMP),
)


def _decode_v0_23_5(data: bytes, off: int) -> VoteState:
    """VoteState0_23_5: single (voter, epoch) pair instead of the
    authorized_voters map; prior_voters entries are 4-tuples and the
    CircBuf has no is_empty flag."""
    node, off = T.Pubkey.decode(data, off)
    voter, off = T.Pubkey.decode(data, off)
    voter_epoch, off = T.U64.decode(data, off)
    prior = []
    for _ in range(32):
        pk, off = T.Pubkey.decode(data, off)
        a, off = T.U64.decode(data, off)
        b, off = T.U64.decode(data, off)
        _slot, off = T.U64.decode(data, off)
        prior.append((pk, a, b))
    idx, off = T.U64.decode(data, off)
    withdrawer, off = T.Pubkey.decode(data, off)
    commission, off = T.U8.decode(data, off)
    votes, off = T.Vec(LOCKOUT, max_len=64).decode(data, off)
    root, off = T.Option(T.U64).decode(data, off)
    credits, off = _EpochCredits().decode(data, off)
    ts, off = BLOCK_TIMESTAMP.decode(data, off)
    return VoteState(
        node_pubkey=node,
        authorized_withdrawer=withdrawer,
        commission=commission,
        votes=[LandedVote(0, lk) for lk in votes],
        root_slot=root,
        authorized_voters={voter_epoch: voter},
        prior_voters=PriorVoters(prior, idx,
                                 all(pk == bytes(32) for pk, _, _ in prior)),
        epoch_credits=credits,
        last_timestamp=ts,
    )


def vote_state_encode(vs: VoteState) -> bytes:
    """Current-version envelope (enum tag 2)."""
    return T.U32.encode(2) + _VOTE_STATE_BODY.encode(vs)


def vote_state_decode(data: bytes) -> VoteState:
    """Decode ANY VoteStateVersions envelope, upgrading old layouts to
    the current view (the reference's vote_state_versions convert)."""
    tag, off = T.U32.decode(data, 0)
    if tag == 2:
        vs, _ = _VOTE_STATE_BODY.decode(data, off)
        return vs
    if tag == 1:
        vs, _ = _VOTE_STATE_BODY_1_14_11.decode(data, off)
        vs.votes = [LandedVote(0, lk) for lk in vs.votes]
        return vs
    if tag == 0:
        return _decode_v0_23_5(data, off)
    raise T.CodecError(f"unsupported VoteState version {tag}")


# -- stake state ---------------------------------------------------------------


@dataclass
class Authorized:
    staker: bytes = bytes(32)
    withdrawer: bytes = bytes(32)


AUTHORIZED = T.StructCodec(
    Authorized, ("staker", T.Pubkey), ("withdrawer", T.Pubkey),
)


@dataclass
class Lockup:
    unix_timestamp: int = 0
    epoch: int = 0
    custodian: bytes = bytes(32)


LOCKUP = T.StructCodec(
    Lockup, ("unix_timestamp", T.I64), ("epoch", T.U64),
    ("custodian", T.Pubkey),
)


@dataclass
class Meta:
    rent_exempt_reserve: int = 0
    authorized: Authorized = field(default_factory=Authorized)
    lockup: Lockup = field(default_factory=Lockup)


META = T.StructCodec(
    Meta, ("rent_exempt_reserve", T.U64), ("authorized", AUTHORIZED),
    ("lockup", LOCKUP),
)


@dataclass
class Delegation:
    voter_pubkey: bytes = bytes(32)
    stake: int = 0
    activation_epoch: int = 0
    deactivation_epoch: int = U64_MAX
    warmup_cooldown_rate: float = 0.25


DELEGATION = T.StructCodec(
    Delegation,
    ("voter_pubkey", T.Pubkey),
    ("stake", T.U64),
    ("activation_epoch", T.U64),
    ("deactivation_epoch", T.U64),
    ("warmup_cooldown_rate", T.F64),
)


@dataclass
class StakeV2:
    delegation: Delegation = field(default_factory=Delegation)
    credits_observed: int = 0


STAKE_V2 = T.StructCodec(
    StakeV2, ("delegation", DELEGATION), ("credits_observed", T.U64),
)


@dataclass
class StakeMetaPair:
    meta: Meta = field(default_factory=Meta)
    stake: StakeV2 = field(default_factory=StakeV2)
    flags: int = 0


class _StakePairCodec(T.Codec):
    def encode(self, v: StakeMetaPair) -> bytes:
        return META.encode(v.meta) + STAKE_V2.encode(v.stake) \
            + T.U8.encode(v.flags)

    def decode(self, buf, off=0):
        meta, off = META.decode(buf, off)
        stake, off = STAKE_V2.decode(buf, off)
        flags, off = T.U8.decode(buf, off)
        return StakeMetaPair(meta, stake, flags), off


STAKE_STATE_V2 = T.Enum(
    (0, "uninitialized", None),
    (1, "initialized", META),
    (2, "stake", _StakePairCodec()),
    (3, "rewards_pool", None),
)


# -- converters into the runtime's internal views ------------------------------


def to_internal_stake(data: bytes):
    """Agave StakeStateV2 account bytes -> flamenco/stake.StakeState
    (the runtime's compact view); None for uninitialized/rewards-pool."""
    from . import stake as S

    (kind, payload), _ = STAKE_STATE_V2.decode(data, 0)
    if kind == "initialized":
        return S.StakeState(
            state=S.STATE_INIT,
            staker=payload.authorized.staker,
            withdrawer=payload.authorized.withdrawer,
        )
    if kind == "stake":
        d = payload.stake.delegation
        return S.StakeState(
            state=S.STATE_DELEGATED,
            staker=payload.meta.authorized.staker,
            withdrawer=payload.meta.authorized.withdrawer,
            voter=d.voter_pubkey,
            stake=d.stake,
            activation_epoch=d.activation_epoch,
            deactivation_epoch=d.deactivation_epoch,
        )
    return None


def vote_account_summary(data: bytes, *, epoch: int) -> dict:
    """The fields consensus consumes from a real vote account: node
    identity, the epoch's authorized voter, credits, last vote."""
    vs = vote_state_decode(data)
    return {
        "node_pubkey": vs.node_pubkey,
        "authorized_voter": vs.authorized_voter_for(epoch),
        "authorized_withdrawer": vs.authorized_withdrawer,
        "commission": vs.commission,
        "credits": vs.credits(),
        "last_voted_slot": (
            vs.votes[-1].lockout.slot if vs.votes else None
        ),
        "root_slot": vs.root_slot,
    }
