"""Runtime: slot execution over funk with conflict waves, and the bank hash
(the port's counterpart of firedancer_tpu/flamenco/runtime.py, its Python
lane).

A block's transactions execute against a funk fork in waves, maximal
groups of transactions with disjoint account rw-sets; the slot finalizes
into a bank hash chaining the parent hash, the accounts-delta lattice
hash, the signature count and the PoH hash.  The accounts-delta hash sums
every changed account's lattice hash (+new, -old) in ONE launch of K13
(ops/lthash.combine_device) on the SlotExecution's device; each account's
BLAKE3 XOF stays on the host, as in the JAX package.

Account model: funk value bytes = `u64 lamports | 32B owner |
u8 executable | data` (executor.acct_encode/decode).  A failed txn still
pays its fee; errors never abort the block.  A v0 txn's address-table
lookups resolve against the start-of-slot view (flamenco/alt.py) before
the waves; a lookup that does not resolve fails the txn typed
(TXN_ERR_ACCT, no fee).  Upgradeable programs' programdata resolves at
txn load from the working fork, so an Upgrade earlier in the block is
seen (and the deploy-slot rule then fails the invocation typed).  A
stale blockhash passes only as a durable-nonce txn
(flamenco/nonce.py); its nonce advances against the parent bank hash,
also when the txn fails with its fee charged.

Two lanes execute a txn.  The Python lane (`execute`) gates and runs one
txn through the executor.  The native lane (`execute_batch` with
native_exec=True, the default) sends each run of eligible txns (system,
durable nonce, stake, the vote tags of exec_native.NATIVE_VOTE_TAGS) through
one call of native/fd_exec_native.cpp against the slot's session, which
holds the status-cache gate and an overlay of account values; a txn the
C++ side punts resumes on the Python lane.  Both give the same statuses,
fees, compute units, account bytes and bank hash.  Replay (`execute_block`)
runs the Python lane.

The bank sweep lane (runtime/bank_native.py) runs microblocks against the
same session from C, before Python sees them; its protocol here:
`native_sync` re-ships the status-cache delta and the accounts the Python
lane wrote (refresh records) before each sweep, and `native_apply_rec`,
`native_apply_batch` and `native_apply_group` apply the committed records
to funk, in order, with the compute units the Python lane would report.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from dataclasses import dataclass

import numpy as np

from ..funk import Funk
from ..ops import lthash as lt
from ..pack.cost import BUILTIN_COST, txn_budget
from ..protocol import txn as ft
from ..utils.platform import resolve_device
from . import alt
from . import bpf_loader as bl
from . import exec_native
from . import nonce as N
from . import types as T
from .executor import (
    Account,
    Executor,
    InstrAccount,
    InstrError,
    TxnCtx,
    acct_decode,
    acct_encode,
)
from .programs import AcctError, FundsError

_xid_seq = itertools.count()

LAMPORTS_PER_SIGNATURE = 5000

TXN_SUCCESS = 0
TXN_ERR_FEE = -1                 # payer cannot cover the fee: txn dropped
TXN_ERR_INSUFFICIENT_FUNDS = -2  # program failed: fee charged, no effects
TXN_ERR_ACCT = -3                # unresolvable account index
TXN_ERR_PROGRAM = -4             # program error: fee charged, no effects
TXN_ERR_BLOCKHASH = -5           # recent_blockhash unknown/expired: no fee
TXN_ERR_ALREADY_PROCESSED = -6   # signature already landed on this fork


def acct_lamports(val: bytes | None) -> int:
    return acct_decode(val)[0]


def acct_build(lamports: int, data: bytes = b"",
               owner: bytes = ft.SYSTEM_PROGRAM,
               executable: bool = False) -> bytes:
    return acct_encode(lamports, owner, executable, data)


@dataclass
class TxnResult:
    status: int
    fee: int
    cu: int = 0  # compute units the txn's instructions consumed (a port-only field)


@dataclass
class BlockResult:
    slot: int
    bank_hash: bytes
    accounts_delta: np.ndarray  # (1024,) uint16 lattice value
    signature_cnt: int
    fees: int
    results: list[TxnResult]
    waves: list[list[int]]  # txn indices per wave
    xid: bytes


Extra = tuple[list[bytes], list[bytes]]  # resolved (writable, readonly) lookups


def _rw_sets(payload: bytes, desc: ft.Txn,
             extra: Extra | None = None) -> tuple[set[bytes], set[bytes]]:
    addrs = desc.acct_addrs(payload)
    w, r = set(), set()
    for i, a in enumerate(addrs):
        (w if desc.is_writable(i) else r).add(a)
    if extra is not None:
        # resolved lookups: exact rw sets, plus a READ lock on each table so
        # an in-block extend or close serializes against its users
        w.update(extra[0])
        r.update(extra[1])
        for lut in desc.addr_luts:
            r.add(payload[lut.addr_off : lut.addr_off + 32])
    else:
        # unresolved (a failed lookup, or a caller without resolution):
        # WRITE-lock each table address, so two txns loading from one table
        # never share a wave (pack's rule too)
        for lut in desc.addr_luts:
            w.add(payload[lut.addr_off : lut.addr_off + 32])
    return w, r


def generate_waves(txns: list[tuple[bytes, ft.Txn]],
                   extras: list[Extra | None] | None = None) -> list[list[int]]:
    """Partition txn indices into conflict-free waves, equivalent to
    serial block order: a writer lands strictly after every earlier
    reader AND writer of each of its accounts; a reader lands strictly
    after every earlier writer (readers may share a wave).  No
    gap-filling below a conflict."""
    waves: list[list[int]] = []
    last_w: dict[bytes, int] = {}  # acct -> last wave with a writer
    last_r: dict[bytes, int] = {}  # acct -> last wave with a reader
    for i, (payload, desc) in enumerate(txns):
        w, r = _rw_sets(payload, desc, extras[i] if extras is not None else None)
        wi = 0
        for a in w:
            wi = max(wi, last_w.get(a, -1) + 1, last_r.get(a, -1) + 1)
        for a in r:
            wi = max(wi, last_w.get(a, -1) + 1)
        while wi >= len(waves):
            waves.append([])
        waves[wi].append(i)
        for a in w:
            last_w[a] = max(last_w.get(a, -1), wi)
        for a in r:
            last_r[a] = max(last_r.get(a, -1), wi)
    return waves


_DEFAULT_EXECUTOR: Executor | None = None


def default_executor() -> Executor:
    global _DEFAULT_EXECUTOR
    if _DEFAULT_EXECUTOR is None:
        _DEFAULT_EXECUTOR = Executor()
    return _DEFAULT_EXECUTOR


def default_sysvars(slot: int) -> dict:
    """The sysvar blobs programs read: clock at the executing slot, default
    rent and epoch schedule, and the JAX runtime's other defaults."""
    sched = T.EpochSchedule()
    epoch = slot // sched.slots_per_epoch
    return {
        "clock": T.CLOCK.encode(T.Clock(slot=slot, epoch=epoch)),
        "rent": T.RENT.encode(T.Rent()),
        "epoch_schedule": T.EPOCH_SCHEDULE.encode(sched),
        "slot_hashes": T.SLOT_HASHES.encode([]),
        # Fees { fee_calculator: { lamports_per_signature } }
        "fees": LAMPORTS_PER_SIGNATURE.to_bytes(8, "little"),
        # EpochRewards, inactive outside the distribution window
        "epoch_rewards": bytes(8 + 8 + 32 + 16 + 8 + 8 + 1),
        "last_restart_slot": (0).to_bytes(8, "little"),
        "recent_blockhash": hashlib.sha256(
            b"fdtpu:rbh:" + slot.to_bytes(8, "little")
        ).digest(),
    }


def _advance_nonce_account(funk: Funk, xid: bytes, payload: bytes, desc: ft.Txn,
                           addrs: list[bytes], sysvars: dict | None) -> None:
    """A FAILED durable-nonce txn still advances its nonce account: the fee
    debit and the rotated nonce are the txn's on-chain footprint, else,
    once the status cache prunes the signature, the identical signed txn
    passes durable_nonce_ok again and lands twice."""
    ins = desc.instrs[0]
    key = addrs[payload[ins.acct_off]]
    lam, owner, ex, data = acct_decode(funk.rec_query(xid, key))
    state, auth, _cur = N.decode_state(data)
    if state != N.STATE_INIT:
        return
    bh = (sysvars or {}).get("recent_blockhash")
    if not bh:
        return
    data = bytearray(data)
    data[: N.DATA_LEN] = N.encode_state(N.STATE_INIT, auth, N.next_nonce(bh, key))
    funk.rec_insert(xid, key, acct_encode(lam, owner, ex, bytes(data)))


def _execute_txn(funk: Funk, xid: bytes, payload: bytes, desc: ft.Txn,
                 executor: Executor | None = None,
                 sysvars: dict | None = None,
                 extra: Extra | None = None,
                 durable_nonce: bool = False) -> TxnResult:
    executor = executor or default_executor()
    addrs = desc.acct_addrs(payload)
    if desc.addr_luts:
        if extra is None:
            # the lookups did not resolve: a typed failure, no fee
            return TxnResult(TXN_ERR_ACCT, 0)
        # combined index space: static, then loaded-writable, then
        # loaded-readonly (Txn.is_writable's)
        addrs = addrs + extra[0] + extra[1]
    if len(set(addrs)) != len(addrs):
        # AccountLoadedTwice analog: duplicate addresses would load as
        # independent copies
        return TxnResult(TXN_ERR_ACCT, 0)
    payer = addrs[0]
    fee = LAMPORTS_PER_SIGNATURE * desc.signature_cnt
    payer_val = funk.rec_query(xid, payer)
    if acct_lamports(payer_val) < fee:
        return TxnResult(TXN_ERR_FEE, 0)
    # charge the fee unconditionally (failed txns still pay); written
    # straight to funk so program failure cannot roll it back
    plam, powner, pex, pdata = acct_decode(payer_val)
    funk.rec_insert(xid, payer, acct_encode(plam - fee, powner, pex, pdata))

    ctx = None

    def _fail(status: int) -> TxnResult:
        # fee-charged failure: a durable-nonce txn's nonce must rotate even
        # though every other program effect is discarded
        if durable_nonce:
            _advance_nonce_account(funk, xid, payload, desc, addrs, sysvars)
        return TxnResult(status, fee, ctx.cu_used if ctx is not None else 0)

    # load the unique account set into host objects; program effects land
    # in funk only at commit, so failure = skip the writeback (fee stays)
    accounts = [Account.from_value(a, funk.rec_query(xid, a)) for a in addrs]
    signer = [i < desc.signature_cnt for i in range(len(addrs))]
    writable = [desc.is_writable(i) for i in range(len(addrs))]
    baseline = [a.to_value() for a in accounts]
    budget = txn_budget(payload, desc)
    if budget is None:
        # malformed compute-budget instruction: typed failure, fee stays
        return _fail(TXN_ERR_PROGRAM)
    cu_limit, heap_size = budget
    # resolve upgradeable programs' programdata up front, from the working
    # fork; a broken indirection surfaces as a typed failure at invoke time
    program_elfs: dict = {}
    for a in accounts:
        if a.executable and a.owner == bl.UPGRADEABLE_LOADER_PROGRAM:
            try:
                pd_addr = bl.program_programdata(bytes(a.data))
                _lam, _owner, _ex, pd_data = acct_decode(funk.rec_query(xid, pd_addr))
                deploy_slot, _auth = bl.programdata_meta(pd_data)
                program_elfs[a.key] = (bl.programdata_elf(pd_data), deploy_slot)
            except InstrError:
                pass  # left unresolved: invocation fails typed
    ctx = TxnCtx(accounts=accounts, signer=signer, writable=writable,
                 sysvars=sysvars or {}, budget=cu_limit, heap_size=heap_size,
                 program_elfs=program_elfs,
                 instr_datas=[payload[i.data_off : i.data_off + i.data_sz] for i in desc.instrs])

    for ins in desc.instrs:
        if ins.program_id >= len(addrs):
            return _fail(TXN_ERR_ACCT)
        prog = addrs[ins.program_id]
        data = payload[ins.data_off : ins.data_off + ins.data_sz]
        idx = payload[ins.acct_off : ins.acct_off + ins.acct_cnt]
        if any(i >= len(addrs) for i in idx):
            return _fail(TXN_ERR_ACCT)
        iaccts = [InstrAccount(i, signer[i], writable[i]) for i in idx]
        try:
            executor.execute_instr(ctx, prog, iaccts, data)
        except FundsError:
            return _fail(TXN_ERR_INSUFFICIENT_FUNDS)
        except AcctError:
            return _fail(TXN_ERR_ACCT)
        except InstrError:
            return _fail(TXN_ERR_PROGRAM)
        except (ValueError, IndexError, KeyError, OverflowError):
            # instruction data is attacker input: an untyped exception in
            # a native program is a failed txn, never a block abort
            return _fail(TXN_ERR_PROGRAM)

    # commit: writes may only land on writable accounts; validate
    # everything before the first insert (no partial commits)
    changed = []
    for i, a in enumerate(accounts):
        val = a.to_value()
        if val == baseline[i]:
            continue
        if not writable[i]:
            return _fail(TXN_ERR_ACCT)
        changed.append((a.key, val))
    for key, val in changed:
        funk.rec_insert(xid, key, val)
    return TxnResult(TXN_SUCCESS, fee, ctx.cu_used)


class SlotExecution:
    """Incremental slot execution: the per-txn gate + execute + seal
    machinery shared by `execute_block` (the batch and replay path) and the
    pipeline's bank stages (the streaming leader path).

    Lifecycle: construct (prepares a funk fork), `execute()` txns as they
    arrive, `seal(poh_hash)` to finalize the bank hash (K13 on `device`,
    default the card), then `publish()` or `abandon()` once consensus
    picks the fork."""

    def __init__(
        self,
        funk: Funk,
        *,
        slot: int,
        parent_bank_hash: bytes = b"\x00" * 32,
        parent_xid: bytes | None = None,
        executor: Executor | None = None,
        status_cache=None,
        ancestors: set[int] | None = None,
        slot_hashes: list[tuple[int, bytes]] | None = None,
        device=None,
        native_exec: bool = True,
    ):
        self.device = resolve_device(device)
        self.funk = funk
        self.slot = slot
        self.parent_bank_hash = parent_bank_hash
        self.parent_xid = parent_xid
        self.executor = executor
        self.status_cache = status_cache
        self.ancestors = ancestors
        # the xid carries a nonce: competing blocks for the same slot off
        # the same parent are distinct forks; the parent rides as a digest
        self.xid = b"slot:%d:%d:%s" % (
            slot, next(_xid_seq),
            hashlib.sha256(parent_xid).hexdigest()[:24].encode()
            if parent_xid else b"root")
        funk.txn_prepare(parent_xid, self.xid)
        self.sysvars = default_sysvars(slot)
        # durable nonces advance against the PARENT's bank hash: fresh,
        # deterministic, and fixed before any txn in this block runs
        self.sysvars["recent_blockhash"] = parent_bank_hash
        if slot_hashes is not None:
            self.sysvars["slot_hashes"] = T.SLOT_HASHES.encode(
                [T.SlotHash(s, h) for s, h in slot_hashes])
        if status_cache is not None:
            status_cache.begin_block(self.xid, slot)
        # intra-block duplicates are tracked locally: a speculative
        # competing block's cache inserts must never gate this block
        self._block_seen: set[tuple[bytes, bytes]] = set()
        # unrooted ancestor blocks gate too (their entries are staged)
        self._ancestor_xids: tuple[bytes, ...] = (
            tuple(funk.txn_ancestry(parent_xid)) if parent_xid is not None else ())
        self._table_cache: dict = {}  # lookup tables, decoded once a block
        self._before: dict[bytes, bytes | None] = {}  # start-of-slot view
        # the native lane (exec_native): one session per slot, made with
        # the first BatchContext; the C++ side keeps the status-cache gate
        # and an overlay of account values across microblocks, so each
        # account's value ships once (first touch, or after a Python-lane
        # write dirtied it)
        self.native_exec = native_exec
        self._native_ctx: exec_native.BatchContext | None = None
        self._native_sh_blob = None
        self._native_session: exec_native.Session | None = None
        self._gate_seen_delta: list[bytes] = []  # 96B bh || sig, Python-lane landings
        self._gate_seeded = False
        self._gate_shipped_version = None  # StatusCache.version last shipped
        self._native_known: set[bytes] = set()  # accounts the session holds
        self._native_dirty: set[bytes] = set()  # written by the Python lane since shipped
        # txns committed by the native lane, and its punts resumed in Python
        self.native_done_cnt = 0
        self.native_punt_cnt = 0
        self.results: list[TxnResult] = []
        self.signature_cnt = 0
        self.sealed: BlockResult | None = None
        self.seal_s: dict[str, float] = {}  # seal's host time: xof, combine
        self.seal_rows = 0  # lattice rows K13 summed at seal

    def resolve(self, payload: bytes, desc: ft.Txn) -> Extra | None:
        """Resolve a v0 txn's address-table lookups against the START-of-slot
        state (a table extended in this block serves its new addresses from
        the next slot): ([], []) without tables, None for a typed lookup
        failure."""
        if not desc.addr_luts:
            return ([], [])
        try:
            return alt.resolve_lookups(
                payload, desc, lambda k: self.funk.rec_query(self.parent_xid, k),
                slot=self.slot, table_cache=self._table_cache)
        except alt.LookupError_:
            return None

    def execute(self, payload: bytes, desc: ft.Txn,
                extra: Extra | None | bool = False) -> TxnResult:
        """Gate + execute one txn on this slot's fork.  `extra` is the
        resolved lookups (left at False, they are resolved here)."""
        if extra is False:
            extra = self.resolve(payload, desc)
        # snapshot the start-of-slot value of every account this txn can
        # touch, loaded ones too, for the accounts-delta hash (the PARENT
        # view: an earlier in-block writer must not shift this txn's "before")
        touched = desc.acct_addrs(payload) + (extra[0] + extra[1] if extra else [])
        for a in touched:
            if a not in self._before:
                self._before[a] = self.funk.rec_query(self.parent_xid, a)
        durable = False
        bh = sig = None
        if self.status_cache is not None:
            bh = desc.recent_blockhash(payload)
            sig = desc.signatures(payload)[0]
            if not self.status_cache.is_blockhash_valid(bh, self.slot):
                if not N.durable_nonce_ok(self.funk, self.xid, payload, desc):
                    r = TxnResult(TXN_ERR_BLOCKHASH, 0)
                    self.results.append(r)
                    return r
                durable = True
            if (bh, sig) in self._block_seen or self.status_cache.contains(
                bh, sig, self.ancestors
            ) or self.status_cache.contains_staged(bh, sig, self._ancestor_xids):
                r = TxnResult(TXN_ERR_ALREADY_PROCESSED, 0)
                self.results.append(r)
                return r
        if self._native_session is not None:
            # this txn may write any account it touches: the session's
            # copies go stale until the next touch ships fresh values.
            # Marked after the gate: a gated-out txn writes nothing
            self._native_dirty.update(touched)
        r = _execute_txn(self.funk, self.xid, payload, desc,
                         executor=self.executor, sysvars=self.sysvars, extra=extra,
                         durable_nonce=durable)
        return self._finish(r, desc.signature_cnt, bh, sig)

    def _finish(self, r: TxnResult, sig_cnt: int, bh, sig,
                native: bool = False) -> TxnResult:
        """Bookkeeping after either lane ran a txn: the two must never
        disagree on the landed predicate."""
        if r.fee > 0:
            # the bank hash's signature count covers txns that LANDED
            # (fee-charged), so a streaming leader and a replayer counting
            # only the recorded txns agree on the hash
            self.signature_cnt += sig_cnt
            if self.status_cache is not None:
                self._block_seen.add((bh, sig))
                self.status_cache.stage_insert(self.xid, bh, sig)
                if not native and self._native_session is not None:
                    # a Python-lane landing: the session's gate learns it
                    # on the next crossing (the C++ side inserted its own)
                    self._gate_seen_delta.append(bh + sig)
        self.results.append(r)
        return r

    @staticmethod
    def _unpack_trailer(payload: bytes, desc_bytes: bytes) -> ft.Txn:
        """Packed trailer -> validated Txn (decode_verified's contract)."""
        try:
            desc, end = ft.txn_unpack(desc_bytes)
        except Exception as e:
            raise ValueError(f"packed descriptor unparseable: {e}") from e
        if end != len(desc_bytes):
            raise ValueError("packed descriptor trailer size mismatch")
        if not ft.txn_desc_valid(desc, len(payload)):
            raise ValueError("packed descriptor fails validation")
        return desc

    def execute_batch(self, items) -> list[TxnResult]:
        """Execute a burst of txns in block order (the bank stage's
        per-microblock commit path).  items: (payload, desc, desc_bytes)
        tuples; desc (a Txn) or desc_bytes (the packed trailer) may be
        None, not both.  On the native lane each run of eligible txns goes
        through one call against the slot's session; anything else (lookup
        tables, programs outside the native surface) flushes the run and
        goes through `execute`."""
        base = len(self.results)
        if not self.native_exec:
            for payload, desc, desc_bytes in items:
                if desc is None:
                    desc = self._unpack_trailer(payload, desc_bytes)
                self.execute(payload, desc)
            return self.results[base:]
        nat = self._native_for_batch()
        eligible = exec_native.eligible_packed
        q = self.funk.rec_query
        before = self._before
        known = self._native_known
        dirty = self._native_dirty
        pend: list[list] = []  # [payload, desc_bytes, addrs, vals, bh, sig, sig_cnt]
        for payload, desc, desc_bytes in items:
            if desc_bytes is None:
                desc_bytes = ft.txn_pack(desc)
            psz = len(payload)
            db = desc_bytes
            ok = len(db) >= 17
            if ok:
                sig_cnt = db[1]
                sig_off = db[2] | (db[3] << 8)
                acct_cnt = db[8]
                acct_off = db[9] | (db[10] << 8)
                bh_off = db[11] | (db[12] << 8)
                ok = not (db[13]  # lut_cnt: lookups resolve on the Python lane
                          or sig_cnt == 0
                          or acct_cnt == 0
                          or sig_off + 64 > psz
                          or bh_off + 32 > psz
                          or acct_off + 32 * acct_cnt > psz
                          or not eligible(payload, db))
            if not ok:
                if pend:
                    self._flush_native(nat, pend)
                    pend = []
                if desc is None:
                    desc = self._unpack_trailer(payload, desc_bytes)
                self.execute(payload, desc)
                continue
            addrs = []
            vals = []
            for i in range(acct_cnt):
                a = payload[acct_off + 32 * i : acct_off + 32 * (i + 1)]
                addrs.append(a)
                if a not in before:
                    before[a] = q(self.parent_xid, a)
                if a in known and a not in dirty:
                    vals.append(None)  # the session holds it current
                else:
                    vals.append(q(self.xid, a) or b"")
                    known.add(a)
                    dirty.discard(a)
            pend.append([payload, desc_bytes, addrs, vals,
                         payload[bh_off : bh_off + 32], payload[sig_off : sig_off + 64],
                         sig_cnt])
        if pend:
            self._flush_native(nat, pend)
        return self.results[base:]

    # -- the native lane (exec_native) -----------------------------------------

    def _native_for_batch(self) -> exec_native.BatchContext:
        """The slot's BatchContext: clock, slot hashes, rent and the recent
        blockhash from the sysvars; rebuilt if the slot-hashes blob was
        swapped.  The session outlives a rebuild (only the header changes)."""
        sh = self.sysvars.get("slot_hashes")
        if self._native_ctx is None or self._native_sh_blob is not sh:
            self._native_sh_blob = sh
            clock_slot = clock_epoch = None
            blob = self.sysvars.get("clock")
            if blob:
                try:
                    c = T.CLOCK.decode(blob, 0)[0]
                    clock_slot, clock_epoch = c.slot, c.epoch
                except T.CodecError:
                    pass  # no clock: vote txns fail typed, on both lanes
            # the nonce partial-withdraw floor's rent: flag 2 = a blob that
            # does not decode (the C++ side punts where it needs it)
            rd = T.Rent()  # no blob: the defaults (flamenco/nonce.py)
            rent = (1, rd.lamports_per_byte_year, rd.exemption_threshold)
            rent_blob = self.sysvars.get("rent")
            if rent_blob:
                try:
                    r = T.RENT.decode(rent_blob, 0)[0]
                    rent = (1, r.lamports_per_byte_year, r.exemption_threshold)
                except T.CodecError:
                    rent = (2, rd.lamports_per_byte_year, rd.exemption_threshold)
            if self._native_session is None:
                self._native_session = exec_native.Session()
            self._native_ctx = exec_native.BatchContext(
                lamports_per_sig=LAMPORTS_PER_SIGNATURE, clock_slot=clock_slot,
                clock_epoch=clock_epoch, slot_hashes=sh, session=self._native_session,
                recent_blockhash=self.sysvars.get("recent_blockhash"), rent=rent)
        return self._native_ctx

    def _gate_args(self):
        """(valid blockhashes or None, seen delta) for the next crossing, or
        None without a status cache (the Python lane does not gate then
        either).  The valid set ships only when StatusCache.version moved
        since it last shipped; the first call also seeds the session with
        every landing visible on this fork."""
        sc = self.status_cache
        if sc is None:
            return None
        if sc.version == self._gate_shipped_version and self._gate_seeded:
            valid = None
        else:
            valid = [bh for bh in sc.blockhash_slot if sc.is_blockhash_valid(bh, self.slot)]
        if not self._gate_seeded:
            # one-time seed: what contains() sees on this fork (committed
            # ancestor entries), the unrooted ancestors' staged landings
            # (contains_staged) and this block's landings so far
            self._gate_seeded = True
            vs = set(valid)
            delta = self._gate_seen_delta
            for (bh, sig), slots in sc.seen.items():
                if bh in vs and (self.ancestors is None
                                 or any(s in self.ancestors for s in slots)):
                    delta.append(bh + sig)
            for x in self._ancestor_xids:
                for bh, sig in sc._staged_seen.get(x, ()):
                    if bh in vs:
                        delta.append(bh + sig)
            for bh, sig in self._block_seen:
                delta.append(bh + sig)
        if valid is not None:
            self._gate_shipped_version = sc.version
        return (valid, self._gate_seen_delta)

    def _native_cu(self, payload: bytes, db: bytes, status: int, fee: int) -> int:
        """The compute units the Python lane reports for a txn the native
        lane ran: 0 without a fee, every instruction's builtin cost on
        success.  A failed txn's count stops at the instruction that failed,
        which the response does not carry: the txn runs again on a scratch
        fork of the state it saw (so this is called before its writes
        land), which is then dropped."""
        if fee == 0:
            return 0
        if status == TXN_SUCCESS:
            acct_off = db[9] | (db[10] << 8)
            cu = 0
            for k in range(db[16]):
                prog = db[17 + 9 * k]
                cu += BUILTIN_COST.get(payload[acct_off + 32 * prog : acct_off + 32 * prog + 32], 0)
            return cu
        scratch = self.xid + b":cu"
        self.funk.txn_prepare(self.xid, scratch)
        try:
            return _execute_txn(self.funk, scratch, payload, self._unpack_trailer(payload, db),
                                executor=self.executor, sysvars=self.sysvars,
                                extra=([], [])).cu
        finally:
            self.funk.txn_cancel(scratch)

    def _run_ungated(self, entry) -> None:
        """The Python lane for a punted entry: the session stopped before
        deciding (possibly a stale blockhash, a durable-nonce candidate),
        so the whole of `execute` gates, snapshots and marks it."""
        payload, desc_bytes = entry[0], entry[1]
        self.execute(payload, self._unpack_trailer(payload, desc_bytes), ([], []))

    def _flush_native(self, nat: exec_native.BatchContext, pend: list) -> None:
        """Run the pending eligible txns in order, one call per run: a punt
        resumes on the Python lane, then the remainder goes again, with
        fresh values for the accounts that punt dirtied.  The gate's delta
        rides each call.  A call that does neither progress nor punt
        raises: nothing finishes the run on the Python lane."""
        i = 0
        while i < len(pend):
            chunk = pend[i:]
            gate = self._gate_args()
            n_delta = len(gate[1]) if gate else 0
            n_done, punted, recs = nat.run(chunk, gate=gate)
            if n_delta:
                # the session absorbed these Python-lane landings
                del self._gate_seen_delta[:n_delta]
            for entry, (status, fee, writes) in zip(chunk, recs):
                cu = self._native_cu(entry[0], entry[1], status, fee)
                addrs = entry[2]
                for idx, val in writes:
                    self.funk.rec_insert(self.xid, addrs[idx], val)
                self._finish(TxnResult(status, fee, cu), entry[6], entry[4], entry[5],
                             native=True)
            i += n_done
            self.native_done_cnt += n_done
            if punted and i < len(pend):
                self.native_punt_cnt += 1
                self._run_ungated(pend[i])
                i += 1
                # the punted txn ran on the Python lane and dirtied its
                # accounts: the remainder's session-known values for them
                # ship fresh, the first shipper resyncing the session
                dirty = self._native_dirty
                if dirty:
                    for entry in pend[i:]:
                        vals = entry[3]
                        for j, a in enumerate(entry[2]):
                            if a in dirty:
                                vals[j] = self.funk.rec_query(self.xid, a) or b""
                                dirty.discard(a)
            elif n_done == 0:
                raise exec_native.NativeExecError(
                    f"fd_exec_batch2 made no progress on {len(chunk)} txns")

    # -- the bank sweep's protocol (runtime/bank_native.py) ---------------------

    def native_sync(self) -> None:
        """Make the session coherent before a bank sweep, with ONE zero-txn
        crossing when anything is owed: the status-cache gate's delta (the
        Python lane's landings; the valid set when StatusCache.version
        moved) and a refresh record for every account the Python lane wrote
        since it last shipped.  The sweep's requests carry no account
        values (the overlay is their only source), so this is the lane's
        whole coherence protocol.  A failed crossing raises NativeExecError."""
        sc = self.status_cache
        dirty = self._native_dirty
        if not dirty and (sc is None or (self._gate_seeded and not self._gate_seen_delta
                                         and sc.version == self._gate_shipped_version)):
            return
        nat = self._native_for_batch()
        gate = self._gate_args()
        n_delta = len(gate[1]) if gate else 0
        q = self.funk.rec_query
        refresh = [(a, q(self.xid, a) or b"") for a in sorted(dirty)]
        nat.run([], gate=gate, refresh=refresh)
        if n_delta:
            del self._gate_seen_delta[:n_delta]
        self._native_known.update(dirty)
        dirty.clear()

    def native_apply_rec(self, payload: bytes, db: bytes, status: int, fee: int,
                         writes) -> TxnResult:
        """Apply one txn the sweep committed session-side: its compute units
        (taken first, on the state it saw), its writes to funk with their
        start-of-slot snapshots, and the landed bookkeeping.  writes:
        [(acct_idx, value)], indices into the packed descriptor's account
        table."""
        cu = self._native_cu(payload, db, status, fee)
        if writes:
            acct_off = db[9] | (db[10] << 8)
            before = self._before
            q = self.funk.rec_query
            for idx, val in writes:
                a = payload[acct_off + 32 * idx : acct_off + 32 * (idx + 1)]
                if a not in before:
                    before[a] = q(self.parent_xid, a)
                self.funk.rec_insert(self.xid, a, val)
                self._native_known.add(a)
                self._native_dirty.discard(a)
        bh = sig = None
        if fee > 0 and self.status_cache is not None:
            sig_off = db[2] | (db[3] << 8)
            bh_off = db[11] | (db[12] << 8)
            bh = payload[bh_off : bh_off + 32]
            sig = payload[sig_off : sig_off + 64]
        self.native_done_cnt += 1
        return self._finish(TxnResult(status, fee, cu), db[1], bh, sig, native=True)

    def native_apply_batch(self, txns) -> list[TxnResult]:
        """native_apply_rec over (payload, desc_bytes, status, fee, writes)
        tuples, in order."""
        return [self.native_apply_rec(*t) for t in txns]

    def native_apply_group(self, frags, recs) -> tuple[int, int, int]:
        """One sweep group's records against its verified frags (payload ||
        packed descriptor || u16 payload size), in order: (landed, landed
        but failed, rejected)."""
        n_ok = n_fail = n_rej = 0
        for frag, (status, fee, writes) in zip(frags, recs):
            psz = frag[-2] | (frag[-1] << 8)
            r = self.native_apply_rec(frag[:psz], frag[psz:-2], status, fee, writes)
            if r.fee > 0:
                n_ok += 1
                n_fail += r.status != TXN_SUCCESS
            else:
                n_rej += 1
        return n_ok, n_fail, n_rej

    def seal(self, poh_hash: bytes = b"\x00" * 32,
             waves: list[list[int]] | None = None) -> BlockResult:
        """Finalize: the accounts-delta lattice hash (one launch of K13 over
        +new / -old) chained into the bank hash.  The JAX runtime pads the
        row count to a power of two to bound XLA compiles; K13 takes any
        row count, and zero rows of sign 0 change nothing."""
        t0 = time.perf_counter()
        vals = []
        signs = []
        q = self.funk.rec_query
        for a, before, after in sorted((a, self._before[a], q(self.xid, a))
                                       for a in self._before):
            if after == before:
                continue
            if before is not None:
                vals.append(lt.lthash_of(a + before))
                signs.append(-1)
            if after is not None:
                vals.append(lt.lthash_of(a + after))
                signs.append(1)
        t1 = time.perf_counter()
        if vals:
            delta = lt.combine_device(np.stack(vals), np.asarray(signs, dtype=np.int8),
                                      device=self.device)
            delta = delta.cpu().numpy().astype(np.uint16)
        else:
            delta = lt.lthash_zero()
        bank_hash = hashlib.sha256(
            self.parent_bank_hash
            + hashlib.sha256(delta.tobytes()).digest()
            + self.signature_cnt.to_bytes(8, "little")
            + poh_hash
        ).digest()
        if self.status_cache is not None:
            self.status_cache.stage_blockhash(self.xid, poh_hash)
        self.seal_s = {"xof": t1 - t0, "combine": time.perf_counter() - t1}
        self.seal_rows = len(vals)
        self.sealed = BlockResult(
            slot=self.slot,
            bank_hash=bank_hash,
            accounts_delta=delta,
            signature_cnt=self.signature_cnt,
            fees=sum(r.fee for r in self.results),
            results=list(self.results),
            waves=waves if waves is not None else [],
            xid=self.xid,
        )
        return self.sealed

    def publish(self) -> None:
        """Consensus chose this fork: fold it into funk's root."""
        if self.status_cache is not None:
            self.status_cache.commit_block(self.xid)
        self.funk.txn_publish(self.xid)

    def abandon(self) -> None:
        if self.status_cache is not None:
            self.status_cache.drop_block(self.xid)
        self.funk.txn_cancel(self.xid)


def execute_block(
    funk: Funk,
    *,
    slot: int,
    txns: list[bytes],
    parent_bank_hash: bytes = b"\x00" * 32,
    poh_hash: bytes = b"\x00" * 32,
    parent_xid: bytes | None = None,
    publish: bool = False,
    status_cache=None,
    ancestors: set[int] | None = None,
    slot_hashes: list[tuple[int, bytes]] | None = None,
    device=None,
) -> BlockResult:
    """Execute a block's txns on a fresh funk fork; compute the bank hash
    (K13 on `device`, default the card).

    The fork stays in-prep (consensus decides) unless publish=True.
    status_cache (flamenco/blockstore.StatusCache) arms the recent-
    blockhash currency gate (150-slot age) and the duplicate-signature
    gate (filtered by `ancestors` when given)."""
    parsed = []
    for p in txns:
        t = ft.txn_parse(p)
        if t is None:
            raise ValueError("malformed txn in block")
        parsed.append((p, t))
    sx = SlotExecution(
        funk, slot=slot, parent_bank_hash=parent_bank_hash,
        parent_xid=parent_xid, status_cache=status_cache,
        ancestors=ancestors, slot_hashes=slot_hashes, device=device,
    )
    extras = [sx.resolve(p, t) for p, t in parsed]
    waves = generate_waves(parsed, extras)
    order = [i for wave in waves for i in wave]
    # wave txns are conflict-free: index order within a wave gives the
    # same result as any concurrent order
    for i in order:
        p, t = parsed[i]
        sx.execute(p, t, extra=extras[i])
    # sx.results is in execution order; BlockResult keeps block order
    by_block_order = [None] * len(parsed)
    for pos, i in enumerate(order):
        by_block_order[i] = sx.results[pos]
    sx.results = by_block_order
    result = sx.seal(poh_hash, waves=waves)
    if publish:
        sx.publish()
    return result


def replay_block(
    funk: Funk,
    *,
    slot: int,
    entries: list[tuple[int, bytes, list[bytes]]],
    poh_seed: bytes,
    parent_bank_hash: bytes = b"\x00" * 32,
    parent_xid: bytes | None = None,
    publish: bool = False,
    status_cache=None,
    ancestors: set[int] | None = None,
    slot_hashes: list[tuple[int, bytes]] | None = None,
    device=None,
) -> BlockResult | None:
    """The non-leader path: verify the PoH chain over wire entries, then
    execute the block.  None = PoH fraud."""
    from ..runtime import poh as fpoh

    ok, _segments = fpoh.replay_entries(poh_seed, entries)
    if not ok:
        return None
    txns = [p for _, _, txs in entries for p in txs]
    poh_hash = entries[-1][1] if entries else b"\x00" * 32
    return execute_block(
        funk, slot=slot, txns=txns, parent_bank_hash=parent_bank_hash,
        poh_hash=poh_hash, parent_xid=parent_xid, publish=publish,
        status_cache=status_cache, ancestors=ancestors,
        slot_hashes=slot_hashes, device=device,
    )
