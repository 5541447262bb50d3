"""Address lookup table program and v0 lookup resolution (the port's copy of
firedancer_tpu/flamenco/alt.py).

State layout (Solana's ProgramState bincode, LOOKUP_TABLE_META_SIZE = 56):

    u32  discriminant        0 = Uninitialized, 1 = LookupTable
    u64  deactivation_slot   u64::MAX = active
    u64  last_extended_slot
    u8   last_extended_slot_start_index
    u8   authority_some      Option<Pubkey>
    32B  authority
    u16  padding
    ...  addresses, 32 bytes each, from offset 56

Instructions (bincode enum, u32 tag):

    0 CreateLookupTable { recent_slot u64, bump u8 }
         [table w, authority s, payer s w, system]
    1 FreezeLookupTable     [table w, authority s]
    2 ExtendLookupTable { new_addresses Vec<Pubkey> }
         [table w, authority s, (payer s w, system)]
    3 DeactivateLookupTable [table w, authority s]
    4 CloseLookupTable      [table w, authority s, recipient w]

Resolution timing: a block resolves every txn's lookups against the state
at the START of the slot (the parent fork view), so a table extended in
slot N serves the new addresses from slot N+1, and the resolved rw-sets
are known before any txn executes (wave generation stays exact).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..protocol import pda
from ..protocol.base58 import b58_decode32
from ..protocol.txn import SYSTEM_PROGRAM
from . import types as T
from .executor import acct_decode
from .programs import AcctError, _u32, _u64

ALT_PROGRAM = b58_decode32("AddressLookupTab1e1111111111111111111111111")

U64_MAX = (1 << 64) - 1
META_SIZE = 56
MAX_ADDRESSES = 256
# slots a deactivated table stays resolvable and uncloseable
DEACTIVATE_COOLDOWN_SLOTS = 512


@dataclass
class TableState:
    deactivation_slot: int = U64_MAX
    last_extended_slot: int = 0
    last_extended_start: int = 0
    authority: bytes | None = None
    addresses: list[bytes] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.addresses is None:
            self.addresses = []

    def encode(self) -> bytes:
        out = bytearray()
        out += (1).to_bytes(4, "little")
        out += self.deactivation_slot.to_bytes(8, "little")
        out += self.last_extended_slot.to_bytes(8, "little")
        out += bytes([self.last_extended_start])
        if self.authority is None:
            out += bytes([0]) + bytes(32)
        else:
            out += bytes([1]) + self.authority
        out += bytes(2)  # padding
        assert len(out) == META_SIZE
        for a in self.addresses:
            out += a
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "TableState":
        if len(data) < META_SIZE:
            raise AcctError("lookup table account too small")
        if _u32(data) != 1:
            raise AcctError("account is not an initialized lookup table")
        n = (len(data) - META_SIZE) // 32
        return cls(
            deactivation_slot=_u64(data[4:]),
            last_extended_slot=_u64(data[12:]),
            last_extended_start=data[20],
            authority=data[22:54] if data[21] else None,
            addresses=[data[META_SIZE + 32 * i : META_SIZE + 32 * (i + 1)] for i in range(n)],
        )


def _clock_slot(ctx) -> int:
    blob = ctx.sysvars.get("clock")
    if not blob:
        raise AcctError("lookup table instruction requires the clock sysvar")
    clock, _ = T.CLOCK.decode(blob, 0)
    return clock.slot


def alt_program(executor, ctx, program_id, iaccts, data, *, pda_signers):
    if len(data) < 4:
        raise AcctError("malformed lookup table instruction")
    tag = _u32(data)

    def acct(i):
        if i >= len(iaccts):
            raise AcctError(f"lookup table instr needs account {i}")
        return ctx.accounts[iaccts[i].txn_idx]

    def need_writable(i):
        if i >= len(iaccts):
            raise AcctError(f"lookup table instr needs account {i}")
        if not iaccts[i].is_writable:
            raise AcctError(f"lookup table account {i} not writable")

    def need_signer(i):
        if i >= len(iaccts):
            raise AcctError(f"lookup table instr needs account {i}")
        ia = iaccts[i]
        if not (ia.is_signer or ctx.accounts[ia.txn_idx].key in pda_signers):
            raise AcctError(f"lookup table account {i} must sign")

    def authority_check(st):
        if st.authority is None:
            raise AcctError("lookup table is frozen")
        need_signer(1)
        if acct(1).key != st.authority:
            raise AcctError("wrong lookup table authority")

    if tag == 0:  # CreateLookupTable { recent_slot u64, bump u8 }
        if len(data) < 4 + 9:
            raise AcctError("malformed create_lookup_table")
        recent_slot = _u64(data[4:])
        bump = data[12]
        table, authority = acct(0), acct(1)
        need_writable(0)
        need_signer(2)  # payer
        if recent_slot > _clock_slot(ctx):
            raise AcctError(f"recent_slot {recent_slot} is not a past slot")
        try:
            expect = pda.create_program_address(
                [authority.key, recent_slot.to_bytes(8, "little"), bytes([bump])], ALT_PROGRAM)
        except pda.PdaError as e:
            # an on-curve bump is attacker input: a typed failure, never a
            # block abort
            raise AcctError(f"bad table derivation: {e}") from e
        if expect != table.key:
            raise AcctError("lookup table address derivation mismatch")
        if table.owner == ALT_PROGRAM and len(table.data):
            raise AcctError("lookup table already exists")
        if table.owner != SYSTEM_PROGRAM and table.owner != ALT_PROGRAM:
            raise AcctError("lookup table account has a foreign owner")
        st = TableState(authority=authority.key)
        table.owner = ALT_PROGRAM
        table.data = bytearray(st.encode())
    elif tag == 1:  # FreezeLookupTable
        table = acct(0)
        need_writable(0)
        if table.owner != ALT_PROGRAM:
            raise AcctError("freeze target not a lookup table")
        st = TableState.decode(bytes(table.data))
        authority_check(st)
        if not st.addresses:
            raise AcctError("cannot freeze an empty lookup table")
        st.authority = None
        table.data = bytearray(st.encode())
    elif tag == 2:  # ExtendLookupTable { new_addresses Vec<Pubkey> }
        if len(data) < 4 + 8:
            raise AcctError("malformed extend_lookup_table")
        n = _u64(data[4:])
        if n == 0:
            raise AcctError("extend with no addresses")
        if len(data) < 12 + 32 * n:
            raise AcctError("short extend_lookup_table payload")
        table = acct(0)
        need_writable(0)
        if table.owner != ALT_PROGRAM:
            raise AcctError("extend target not a lookup table")
        st = TableState.decode(bytes(table.data))
        authority_check(st)
        if st.deactivation_slot != U64_MAX:
            raise AcctError("cannot extend a deactivated lookup table")
        if len(st.addresses) + n > MAX_ADDRESSES:
            raise AcctError("lookup table address limit exceeded")
        slot = _clock_slot(ctx)
        if st.last_extended_slot != slot:
            st.last_extended_slot = slot
            st.last_extended_start = len(st.addresses)
        for i in range(n):
            st.addresses.append(data[12 + 32 * i : 12 + 32 * (i + 1)])
        table.data = bytearray(st.encode())
    elif tag == 3:  # DeactivateLookupTable
        table = acct(0)
        need_writable(0)
        if table.owner != ALT_PROGRAM:
            raise AcctError("deactivate target not a lookup table")
        st = TableState.decode(bytes(table.data))
        authority_check(st)
        if st.deactivation_slot != U64_MAX:
            raise AcctError("lookup table already deactivated")
        st.deactivation_slot = _clock_slot(ctx)
        table.data = bytearray(st.encode())
    elif tag == 4:  # CloseLookupTable
        table, recipient = acct(0), acct(2)
        need_writable(0)
        need_writable(2)
        if table.owner != ALT_PROGRAM:
            raise AcctError("close target not a lookup table")
        st = TableState.decode(bytes(table.data))
        authority_check(st)
        if st.deactivation_slot == U64_MAX:
            raise AcctError("cannot close an active lookup table")
        if _clock_slot(ctx) <= st.deactivation_slot + DEACTIVATE_COOLDOWN_SLOTS:
            raise AcctError("lookup table still in deactivation cooldown")
        if table.key == recipient.key:
            raise AcctError("cannot close table into itself")
        recipient.lamports += table.lamports
        table.lamports = 0
        table.data = bytearray()
        table.owner = SYSTEM_PROGRAM
    else:
        raise AcctError(f"unknown lookup table instruction {tag}")


# -- executor-side resolution -------------------------------------------------


class LookupError_(AcctError):
    """A v0 lookup could not resolve (missing, foreign or short table, index
    out of range, table past its cooldown): fails the TRANSACTION, never the
    block."""


def _load_table(key: bytes, load, cache: dict | None) -> TableState:
    if cache is not None and key in cache:
        hit = cache[key]
        if isinstance(hit, LookupError_):
            raise hit
        return hit
    try:
        st = _load_table_uncached(key, load)
    except LookupError_ as e:
        if cache is not None:
            cache[key] = e
        raise
    if cache is not None:
        cache[key] = st
    return st


def _load_table_uncached(key: bytes, load) -> TableState:
    val = load(key)
    if val is None:
        raise LookupError_("lookup table account missing")
    _, owner, _, data = acct_decode(val)
    if owner != ALT_PROGRAM:
        raise LookupError_("lookup table owned by a foreign program")
    try:
        return TableState.decode(data)
    except AcctError as e:
        raise LookupError_(str(e)) from e


def resolve_lookups(
    payload: bytes, desc, load, *, slot: int | None = None,
    table_cache: dict | None = None,
) -> tuple[list[bytes], list[bytes]]:
    """Resolve a parsed v0 txn's address-table lookups.

    load(key) -> account value bytes | None (the funk record at the start
    of the slot).  Returns (writable_addrs, readonly_addrs) in lookup order:
    the combined account list is static + writable_addrs + readonly_addrs,
    Txn.is_writable's index space.  Raises LookupError_ on any lookup that
    does not resolve.

    slot: when given, a table whose deactivation cooldown has passed no
    longer resolves.  table_cache: an optional per-block memo (key ->
    TableState | LookupError_), so N txns on one table decode it once;
    resolution reads the start of the slot, so reuse within a block is
    exact.
    """
    writable: list[bytes] = []
    readonly: list[bytes] = []
    for lut in desc.addr_luts:
        key = payload[lut.addr_off : lut.addr_off + 32]
        st = _load_table(key, load, table_cache)
        if slot is not None and st.deactivation_slot != U64_MAX and (
            slot > st.deactivation_slot + DEACTIVATE_COOLDOWN_SLOTS
        ):
            raise LookupError_("lookup table is deactivated")
        for off, cnt, sink in (
            (lut.writable_off, lut.writable_cnt, writable),
            (lut.readonly_off, lut.readonly_cnt, readonly),
        ):
            for i in range(cnt):
                idx = payload[off + i]
                if idx >= len(st.addresses):
                    raise LookupError_(
                        f"lookup index {idx} out of range ({len(st.addresses)} addresses)")
                sink.append(st.addresses[idx])
    return writable, readonly
