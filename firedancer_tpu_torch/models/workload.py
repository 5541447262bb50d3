"""Seeded verify workloads with known answers: a mixed signature batch in
the kernel layout, a txn stream for the verify pipeline, and a vote-heavy
stream with the genesis a leader needs to land it.  All are made from a
seed with numpy and signed with the port's ed25519_ref, so the same inputs
can go through the JAX package and the port, and the expected masks and
counters are known up front."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ..ops.ref import ed25519_ref as ref
from ..protocol import txn as ft
from ..runtime.benchg import gen_transfer_pool, pool_blockhash, pool_payers
from ..runtime.verify import encode_verified

P = ref.P
L = ref.L

# lane categories of the mixed batch, cycled over the real lanes
CATEGORIES = ("honest", "bad_msg", "bad_r", "high_s", "small_a", "small_r",
              "noncanon_a", "nonsquare_a", "noncanon_r", "nonsquare_r")


def _sqrt_mod(a: int):
    a %= P
    x = pow(a, (P + 3) // 8, P)
    if (x * x - a) % P:
        x = x * ref.SQRT_M1 % P
    return x if (x * x - a) % P == 0 else None


def torsion_encodings() -> list[bytes]:
    """Encodings of the 8-torsion points (identity y=1, order 2 y=-1,
    order 4 y=0, order 8 from d y^4 + 2 y^2 - 1 = 0)."""
    ys = [1, P - 1, 0]
    s = _sqrt_mod(1 + ref.D)
    for r in (s, P - s):
        y = _sqrt_mod((r - 1) * pow(ref.D, P - 2, P))
        if y is not None:
            ys += [y, P - y]
    return [y.to_bytes(32, "little") for y in ys]


def noncanonical_encodings() -> list[bytes]:
    """y in [p, 2^255) that decompress (the value y - p is a valid y)."""
    out = []
    for y in range(P, 1 << 255):
        enc = y.to_bytes(32, "little")
        if ref.point_decompress(enc) is not None:
            out.append(enc)
    return out


def nonsquare_encodings(n: int = 4) -> list[bytes]:
    """Small y whose x^2 is not a square: not curve points."""
    out, v = [], 2
    while len(out) < n:
        enc = v.to_bytes(32, "little")
        if ref.point_decompress(enc) is None:
            out.append(enc)
        v += 1
    return out


@dataclass
class MixedBatch:
    msg: np.ndarray      # (max_msg_len, B) uint8
    msg_len: np.ndarray  # (B,) int32
    sig: np.ndarray      # (64, B) uint8
    pubkey: np.ndarray   # (32, B) uint8
    n_real: int
    categories: list     # per lane ("pad" past n_real)
    labels: np.ndarray   # (B,) bool: ed25519_ref.verify, False past n_real


def mixed_batch(batch: int, max_msg_len: int, n_real: int | None = None,
                seed: int = 0, n_keys: int = 64) -> MixedBatch:
    """Honest signatures, corrupted messages, corrupted R, high s,
    small-order A and R, non-canonical y, non-square y, and pad lanes past
    n_real (filled with honest triples, so the pad mask matters)."""
    n_real = batch if n_real is None else n_real
    rng = np.random.default_rng(seed)
    tors, nonc, nsq = torsion_encodings(), noncanonical_encodings(), nonsquare_encodings()
    keys = []
    for k in range(min(n_keys, batch)):
        secret = hashlib.sha256(b"mixed%d/%d" % (seed, k)).digest()
        keys.append((secret, ref.public_key(secret)))
    msg = np.zeros((max_msg_len, batch), dtype=np.uint8)
    msg_len = np.zeros((batch,), dtype=np.int32)
    sig = np.zeros((64, batch), dtype=np.uint8)
    pk = np.zeros((32, batch), dtype=np.uint8)
    cats, labels = [], np.zeros((batch,), dtype=bool)
    for i in range(batch):
        cat = CATEGORIES[i % len(CATEGORIES)] if i < n_real else "pad"
        secret, pub = keys[i % len(keys)]
        n = int(rng.integers(1, max_msg_len + 1))
        m = rng.bytes(n)
        s = ref.sign(secret, m)
        if cat == "bad_msg":
            m = m[:-1] + bytes([m[-1] ^ 0x01])
        elif cat == "bad_r":
            s = bytes([s[0] ^ 0x04]) + s[1:]
        elif cat == "high_s":
            s = s[:32] + (int.from_bytes(s[32:], "little") + L).to_bytes(32, "little")
        elif cat == "small_a":
            pub = tors[i % len(tors)]
        elif cat == "small_r":
            s = tors[i % len(tors)] + s[32:]
        elif cat == "noncanon_a":
            pub = nonc[i % len(nonc)]
        elif cat == "nonsquare_a":
            pub = nsq[i % len(nsq)]
        elif cat == "noncanon_r":
            s = nonc[i % len(nonc)] + s[32:]
        elif cat == "nonsquare_r":
            s = nsq[i % len(nsq)] + s[32:]
        msg[:n, i] = np.frombuffer(m, dtype=np.uint8)
        msg_len[i] = n
        sig[:, i] = np.frombuffer(s, dtype=np.uint8)
        pk[:, i] = np.frombuffer(pub, dtype=np.uint8)
        cats.append(cat)
        labels[i] = i < n_real and ref.verify(m, s, pub)
    return MixedBatch(msg, msg_len, sig, pk, n_real, cats, labels)


# -- the pipeline stream -------------------------------------------------------------

def multisig_txn(secrets: list[bytes], pubs: list[bytes], blockhash: bytes,
                 nonce: int, bad_sig: int | None = None) -> bytes:
    """A legacy txn signed by every key in `pubs` (one instruction naming
    the first signer), built with message_build and txn_assemble.  With
    bad_sig=j, signature j is over a different message."""
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=len(pubs), readonly_signed_cnt=0,
        readonly_unsigned_cnt=0, acct_addrs=list(pubs),
        recent_blockhash=blockhash,
        instrs=[ft.InstrSpec(program_id=1, accounts=bytes([0]),
                             data=nonce.to_bytes(4, "little"))],
    )
    sigs = [ref.sign(sk, msg if j != bad_sig else msg + b"x")
            for j, sk in enumerate(secrets)]
    return ft.txn_assemble(sigs, msg)


@dataclass
class VerifyStream:
    stream: list          # frames in send order
    expect_sunk: list     # verified frames the sink must hold, in order
    expect: dict          # counter name -> expected value


def verify_stream(n_transfers: int, *, seed: bytes = b"benchg",
                  self_transfer: bool = False, n_multisig: int = 3,
                  n_corrupt: int = 3, n_resend: int = 3,
                  n_long: int = 0) -> VerifyStream:
    """Honest transfers (benchg's pool, or 1-sig self-transfers whose
    118-byte message fits max_msg_len 128), good and bad multi-sig txns,
    corrupted txns, malformed frames, a duplicate inside the verify tile's
    16-deep tcache, transfers with the 150-byte message (msg_too_long when
    max_msg_len < 150), and resent duplicates past the tile tcache that
    only the global dedup stage catches."""
    n_all = n_transfers + n_corrupt
    if self_transfer:
        payers = pool_payers(seed, max(1, min(8, n_all)))
        bh = pool_blockhash(seed)
        all_honest = [ft.transfer_txn(payers[i % len(payers)][0],
                                      payers[i % len(payers)][1], 1 + i, bh,
                                      from_pubkey=payers[i % len(payers)][1])
                      for i in range(n_all)]
        long_txns = gen_transfer_pool(n_long, seed=seed + b"long") if n_long else []
    else:
        all_honest = gen_transfer_pool(n_all, seed=seed)
        long_txns = []
    honest = all_honest[:n_transfers]
    keys = [hashlib.sha256(seed + b"multi%d" % k).digest() for k in range(3)]
    pubs = [ref.public_key(k) for k in keys]
    bh = pool_blockhash(seed)
    # 2 signers keep the message under 128 bytes; 3 signers do not
    n_sign = [2 if self_transfer else 2 + (j % 2) for j in range(n_multisig)]
    multi = [multisig_txn(keys[:n_sign[j]], pubs[:n_sign[j]], bh, j)
             for j in range(n_multisig)]
    bad_multi = multisig_txn(keys[:2], pubs[:2], bh, 999, bad_sig=1)
    # corrupted copies of txns never sent intact (a corrupted copy of a sent
    # txn shares its first signature and would hit the tile tcache)
    corrupt = []
    for p in all_honest[n_transfers:]:
        p = bytearray(p)
        p[-1] ^= 0x01  # last byte of the signed message (lamports)
        corrupt.append(bytes(p))
    malformed = [b"\x01" + b"garbage" * 12, b""]

    stream = list(honest[: n_transfers // 2])
    stream.insert(3, honest[2])  # duplicate inside the tile tcache window
    stream += multi + [bad_multi] + corrupt + malformed + long_txns
    stream += honest[n_transfers // 2:]
    stream += honest[:n_resend]  # resent past the tile tcache
    good = set(honest) | set(multi)
    seen, sunk = set(), []
    for p in stream:
        if p in good and p not in seen:
            seen.add(p)
            sunk.append(encode_verified(p, ft.txn_parse(p)))
    expect = {
        "txn_verified": len(honest) + len(multi) + n_resend,
        "verify_fail": n_corrupt + 1,
        "parse_fail": len(malformed),
        "tile_dedup_dup": 1,
        "msg_too_long": len(long_txns),
        "dedup_dup": n_resend,
        "sunk": len(sunk),
    }
    return VerifyStream(stream, sunk, expect)


# -- the vote-heavy stream (the comb lane's traffic) -------------------------

def voter_keys(n_voters: int, seed: bytes = b"votes") -> list[tuple[bytes, bytes]]:
    """[(secret, pubkey)] of `n_voters` validators' vote keys, from the seed."""
    out = []
    for i in range(n_voters):
        secret = hashlib.sha256(seed + b"voter%d" % i).digest()
        out.append((secret, ref.public_key(secret)))
    return out


@dataclass
class VoteStream:
    stream: list          # frames in send order
    wave1: int            # stream[:wave1] is rounds 1-2, the rest is wave 2
    expect_sunk: list     # verified frames the sink must hold (either lane order)
    expect: dict          # counter name -> expected value
    voters: list          # [(secret, pubkey)] of the valid voters
    accts: list           # voters[i]'s vote account
    seed: bytes           # the transfers' benchg seed (payers, blockhash)
    n_payers: int         # the transfers' payers: pool_payers(seed, n_payers)
    slot_hashes: list     # [(slot, bank hash)] the stream's votes sign


def vote_stream(n_voters: int, n_rounds: int, *, seed: bytes = b"votes",
                n_transfers: int = 0, n_payers: int = 8, n_corrupt: int = 3,
                n_multisig: int = 2, n_resend: int = 1,
                first_slot: int = 1000) -> VoteStream:
    """A leader's ingress during its slots: every voter signs one vote per
    slot with its one key, for `n_rounds` slots, mixed with benchg
    transfers from `n_payers` payers; plus, in every round, a vote from a
    voter whose pubkey does not decode, and in wave 2 corrupted votes from
    repeat voters, two-signer txns of a repeat voter and a fresh key, and
    resent votes past the tile tcache.

    Two waves for a stage with promote_threshold 2: wave 1 (rounds 1-2)
    shows every voter and payer exactly twice (each payer sends one
    transfer per round there), so no element of wave 1 can take the cached
    lane however the stage's fills are timed; wave 2 holds rounds 3.. and
    the rest of the transfers.  With every repeat signer banked before
    wave 2 (a bank of at least n_voters + n_payers slots), `comb_filled`
    and `comb_elems` are known up front, in `expect`.
    """
    if n_rounds < 3:
        raise ValueError("vote_stream: need at least 3 rounds (2 in wave 1)")
    voters = voter_keys(n_voters, seed)
    accts = [hashlib.sha256(seed + b"vote-acct%d" % i).digest() for i in range(n_voters)]
    bh = pool_blockhash(seed)
    bad_secret = hashlib.sha256(seed + b"bad-voter").digest()
    bad_pub = nonsquare_encodings(1)[0]
    bad_acct = hashlib.sha256(seed + b"bad-acct").digest()
    n_p = min(n_payers, n_transfers)
    if n_transfers and n_transfers < 2 * n_p:
        raise ValueError("vote_stream: need two transfers per payer in wave 1")
    xfers = gen_transfer_pool(n_transfers, seed=seed, n_payers=n_p) if n_transfers else []
    per_round = [xfers[:n_p], xfers[n_p:2 * n_p]]
    per_round += [list(a) for a in np.array_split(np.array(xfers[2 * n_p:], dtype=object),
                                                  n_rounds - 2)]

    def votes(r: int) -> list[bytes]:
        slot = first_slot + r
        out = [ft.vote_txn(sk, accts[i], slot, bh, voter_pubkey=pk)
               for i, (sk, pk) in enumerate(voters)]
        # last in its round: a full fill queue refuses it before any voter
        return out + [ft.vote_txn(bad_secret, bad_acct, slot, bh, voter_pubkey=bad_pub)]

    rounds = [list(per_round[r]) + votes(r) for r in range(n_rounds)]
    wave1 = len(rounds[0]) + len(rounds[1])
    corrupt = []
    for c in range(n_corrupt):
        i = c % n_voters
        p = bytearray(ft.vote_txn(voters[i][0], accts[i], first_slot + n_rounds + c, bh,
                                  voter_pubkey=voters[i][1]))
        p[-1] ^= 0x01  # the last byte of the signed message
        corrupt.append(bytes(p))
    multi = []
    for k in range(n_multisig):
        fresh = hashlib.sha256(seed + b"fresh%d" % k).digest()
        sk, pk = voters[k % n_voters]
        multi.append(multisig_txn([sk, fresh], [pk, ref.public_key(fresh)], bh, k))
    resend = rounds[0][n_p:n_p + n_resend]  # round-1 votes, long past the tile tcache
    rounds[2] = rounds[2] + corrupt + multi + resend
    stream = [p for r in rounds for p in r]
    good = {p for r in rounds for p in r
            if p not in corrupt and ft.txn_parse(p).signers(p)[0] != bad_pub}
    seen, sunk = set(), []
    for p in stream:
        if p in good and p not in seen:
            seen.add(p)
            sunk.append(encode_verified(p, ft.txn_parse(p)))
    n_votes = n_voters * n_rounds
    expect = {
        "txn_verified": n_votes + n_transfers + n_multisig + n_resend,
        "verify_fail": n_rounds + n_corrupt,
        "parse_fail": 0,
        "tile_dedup_dup": 0,
        "dedup_dup": n_resend,
        "sunk": len(sunk),
        "comb_filled": n_voters + n_p,
        # wave 2's elements whose signers are all banked: votes, transfers,
        # corrupted votes and resends (not the two-signer txns)
        "comb_elems": (n_voters * (n_rounds - 2) + n_transfers - 2 * n_p
                       + n_corrupt + n_resend),
    }
    # vote_txn signs the zero bank hash by default
    slot_hashes = [(first_slot + r, bytes(32)) for r in range(n_rounds)]
    return VoteStream(stream, wave1, sunk, expect, voters, accts, seed, n_p, slot_hashes)


VOTE_ACCT_LAMPORTS = 10**9  # each voter's vote account (JAX tests/test_pipeline.py:272)
PAYER_LAMPORTS = 10**12     # each fee payer, as default_bank_ctx funds benchg's


def vote_genesis(vs: VoteStream) -> dict:
    """{pubkey: account value} a leader needs to land `vs`: the transfers'
    payers and the voters funded, and each voter's vote account
    (VOTE_STATE_SIZE bytes owned by the vote program, authorized_voters
    {0: voter}, the voter as node and withdrawer).  The values are the
    funk record encoding both packages share (flamenco/executor.py
    acct_encode), so a JAX Funk can hold the same genesis."""
    from ..flamenco import agave_state as ast
    from ..flamenco.executor import acct_encode
    from ..flamenco.vote_program import VOTE_STATE_SIZE

    out = {pub: acct_encode(PAYER_LAMPORTS) for _, pub in pool_payers(vs.seed, vs.n_payers)}
    for (_, voter), acct in zip(vs.voters, vs.accts):
        out[voter] = acct_encode(PAYER_LAMPORTS)
        state = ast.VoteState(node_pubkey=voter, authorized_withdrawer=voter,
                              authorized_voters={0: voter})
        out[acct] = acct_encode(VOTE_ACCT_LAMPORTS, ft.VOTE_PROGRAM,
                                data=ast.vote_state_encode(state).ljust(VOTE_STATE_SIZE, b"\x00"))
    return out


def vote_slot(vs: VoteStream) -> int:
    """The leader's slot for `vs`: the first past every slot its votes
    name."""
    return vs.slot_hashes[-1][0] + 1


def vote_bank_ctx(vs: VoteStream, *, device=None):
    """A BankCtx at vote_slot(vs) that lands `vs`: vote_genesis on the funk
    root, the transfers' blockhash registered with the status cache, and
    the slot's SlotHashes sysvar holding vs.slot_hashes (what the vote
    program checks each vote against; a replayer passes the same list to
    replay_block)."""
    from ..flamenco import types as T
    from ..flamenco.blockstore import StatusCache
    from ..runtime.bank import BankCtx

    ctx = BankCtx(slot=vote_slot(vs), status_cache=StatusCache(),
                  blockhashes=(pool_blockhash(vs.seed),), device=device)
    for pub, val in vote_genesis(vs).items():
        ctx.funk.rec_insert(None, pub, val)
    ctx.sx.sysvars["slot_hashes"] = T.SLOT_HASHES.encode(
        [T.SlotHash(s, h) for s, h in vs.slot_hashes])
    return ctx


# -- durable-nonce traffic: offline and custodial signers ------------------------------


def nonce_keys(n: int, seed: bytes = b"nonce") -> list[tuple[bytes, bytes, bytes, bytes]]:
    """[(authority secret, authority pubkey, nonce account, stored nonce)] of
    `n` durable-nonce accounts, from the seed.  The stored nonce is a hash
    the status cache never holds, so a txn carrying it passes the
    blockhash check only through the durable-nonce gate."""
    out = []
    for i in range(n):
        secret = hashlib.sha256(seed + b"authority%d" % i).digest()
        out.append((secret, ref.public_key(secret),
                    hashlib.sha256(seed + b"nonce-acct%d" % i).digest(),
                    hashlib.sha256(seed + b"stored%d" % i).digest()))
    return out


def nonce_genesis(n: int, seed: bytes = b"nonce") -> dict:
    """{pubkey: account value} for `n` durable-nonce accounts: each one
    initialized (nonce.encode_state(STATE_INIT, authority, stored)),
    system-owned and rent-exempt, and each authority funded as a fee payer.
    The values are the funk record encoding both packages share."""
    from ..flamenco import nonce
    from ..flamenco import types as T
    from ..flamenco.executor import acct_encode

    rent_min = T.rent_exempt_minimum(T.Rent(), nonce.DATA_LEN)
    out = {}
    for _, auth, acct, stored in nonce_keys(n, seed):
        out[auth] = acct_encode(PAYER_LAMPORTS)
        out[acct] = acct_encode(rent_min, data=nonce.encode_state(nonce.STATE_INIT, auth, stored))
    return out


def nonce_transfers(n: int, seed: bytes = b"nonce", n_dests: int = 64) -> list[bytes]:
    """One signed durable transfer per nonce account of nonce_keys(n, seed):
    instruction 0 is AdvanceNonceAccount [nonce account, authority], then a
    transfer of 1 + i lamports from the authority (the fee payer) to one of
    `n_dests` destinations; the recent_blockhash is the stored nonce."""
    out = []
    for i, (secret, auth, acct, stored) in enumerate(nonce_keys(n, seed)):
        dest = hashlib.sha256(seed + b"to%d" % (i % n_dests)).digest()
        msg = ft.message_build(
            version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0,
            readonly_unsigned_cnt=1, acct_addrs=[auth, acct, dest, ft.SYSTEM_PROGRAM],
            recent_blockhash=stored,
            instrs=[ft.InstrSpec(program_id=3, accounts=bytes([1, 0]),
                                 data=(4).to_bytes(4, "little")),
                    ft.InstrSpec(program_id=3, accounts=bytes([0, 2]),
                                 data=(2).to_bytes(4, "little") + (1 + i).to_bytes(8, "little"))])
        out.append(ft.txn_assemble([ref.sign(secret, msg)], msg))
    return out


def nonce_bank_ctx(n: int, *, seed: bytes = b"nonce", slot: int = 1,
                   payer_seed: bytes = b"benchg", n_payers: int = 8, device=None,
                   native_exec: bool = True, funk=None):
    """default_bank_ctx's payers (benchg's seed and blockhash) plus
    nonce_genesis(n, seed) on the funk root: a BankCtx that lands benchg
    transfers mixed with nonce_transfers(n, seed).  `funk`: the store
    (default make_funk()'s shm map; the caller closes the ctx)."""
    from ..runtime.bank import default_bank_ctx

    ctx = default_bank_ctx(slot=slot, seed=payer_seed, n_payers=n_payers, device=device,
                           native_exec=native_exec, funk=funk)
    for pub, val in nonce_genesis(n, seed).items():
        ctx.funk.rec_insert(None, pub, val)
    return ctx


# -- program traffic: v0 lookups, stake, config and the precompiles ----------------------

PROGRAM_SLOT = 1000      # the program leader's slot: past an expired table's cooldown
STAKE_LAMPORTS = 10**9   # each genesis stake account
CONFIG_DATA_LEN = 2 + 33 + 64  # a one-signer keys block and a 64-byte payload
# the compute-unit limit each stake txn requests: the stake program's id is
# not in pack's builtin table, so without a limit pack costs each stake
# instruction at 200,000 CU, and 256 of them outgrow one block's 48 M
STAKE_CU_LIMIT = 1000


def _lookup_table_value(authority: bytes | None, addresses: list[bytes],
                        deactivation_slot: int | None = None) -> bytes:
    """A ready-made lookup table record, as tests/test_alt.py's make_table
    installs one: one lamport, owned by the lookup table program."""
    from ..flamenco import alt
    from ..flamenco.executor import acct_encode

    st = alt.TableState(authority=authority, addresses=list(addresses))
    if deactivation_slot is not None:
        st.deactivation_slot = deactivation_slot
    return acct_encode(1, alt.ALT_PROGRAM, data=st.encode())


def alt_genesis(dests: list[bytes], *, table_len: int = 64,
                seed: bytes = b"programs") -> tuple[dict, list[bytes]]:
    """({table address: account value}, [table addresses]): active lookup
    tables of `table_len` addresses each over `dests` in order (table t
    holds dests[t * table_len:(t + 1) * table_len])."""
    auth = ref.public_key(hashlib.sha256(seed + b"table-auth").digest())
    out, keys = {}, []
    for t in range(0, len(dests), table_len):
        key = hashlib.sha256(seed + b"table%d" % (t // table_len)).digest()
        out[key] = _lookup_table_value(auth, dests[t : t + table_len])
        keys.append(key)
    return out, keys


def _ix(tag: int, tail: bytes = b"") -> bytes:
    """Instruction data: a u32 tag, then its fields."""
    return tag.to_bytes(4, "little") + tail


def _keyed(seed: bytes, tag: bytes) -> tuple[bytes, bytes]:
    secret = hashlib.sha256(seed + tag).digest()
    return secret, ref.public_key(secret)


def _program_txn(signer: tuple[bytes, bytes], program: bytes, ix_accts: list[bytes],
                 data: bytes, blockhash: bytes, *, readonly: tuple = (),
                 cu_limit: int | None = None, cu_price: int | None = None) -> bytes:
    """A legacy txn paid and signed by `signer` with one instruction to
    `program`, its other accounts writable unless named in `readonly`;
    behind a SetComputeUnitLimit instruction when cu_limit is given (and a
    SetComputeUnitPrice of cu_price micro-lamports a CU after it, when
    given too)."""
    from ..pack.cost import COMPUTE_BUDGET_PROGRAM

    secret, pub = signer
    writable = [a for a in dict.fromkeys(ix_accts) if a != pub and a not in readonly]
    ro = [a for a in dict.fromkeys(ix_accts) if a in readonly]
    progs = [program] + ([COMPUTE_BUDGET_PROGRAM] if cu_limit is not None else [])
    addrs = [pub] + writable + ro + progs
    instrs = [ft.InstrSpec(program_id=len(addrs) - 1, accounts=b"",
                           data=bytes([2]) + cu_limit.to_bytes(4, "little"))
              ] if cu_limit is not None else []
    if cu_limit is not None and cu_price is not None:
        instrs.append(ft.InstrSpec(program_id=len(addrs) - 1, accounts=b"",
                                   data=bytes([3]) + cu_price.to_bytes(8, "little")))
    instrs.append(ft.InstrSpec(program_id=addrs.index(program),
                               accounts=bytes(addrs.index(a) for a in ix_accts), data=data))
    msg = ft.message_build(
        version=ft.VLEGACY, signature_cnt=1, readonly_signed_cnt=0,
        readonly_unsigned_cnt=len(ro) + len(progs), acct_addrs=addrs,
        recent_blockhash=blockhash, instrs=instrs)
    return ft.txn_assemble([ref.sign(secret, msg)], msg)


def v0_transfer(payer: tuple[bytes, bytes], table: bytes, writable_idx: int, lamports: int,
                blockhash: bytes, readonly_idx: int | None = None) -> bytes:
    """A v0 system transfer from `payer` to the address at `writable_idx` of
    lookup table `table` (combined index 2), loading the address at
    `readonly_idx` too when given."""
    secret, pub = payer
    ro = bytes([readonly_idx]) if readonly_idx is not None else b""
    msg = ft.message_build(
        version=ft.V0, signature_cnt=1, readonly_signed_cnt=0, readonly_unsigned_cnt=1,
        acct_addrs=[pub, ft.SYSTEM_PROGRAM], recent_blockhash=blockhash,
        instrs=[ft.InstrSpec(program_id=1, accounts=bytes([0, 2]),
                             data=(2).to_bytes(4, "little") + lamports.to_bytes(8, "little"))],
        luts=[ft.LutSpec(table_addr=table, writable=bytes([writable_idx]), readonly=ro)])
    return ft.txn_assemble([ref.sign(secret, msg)], msg)


@dataclass
class ProgramStream:
    stream: list    # frames in send order
    kind: dict      # payload -> "v0", "legacy", "stake", "config", "ed25519",
    #                 "secp256k1", "lookup" or "alt"
    bad: set        # payloads built to fail typed
    race: set       # pairs of which the first to land succeeds and the other fails
    credit: dict    # transfer payload -> (destination, lamports)
    expect: dict    # kind -> (txns that must land ok, txns that must fail)
    genesis: dict   # pubkey -> account value, the fee payers included
    slot: int       # the leader's slot
    seed: bytes     # the payers' benchg seed (payers, blockhash)


def program_stream(*, n_v0: int = 4096, n_legacy: int = 3500, n_tables: int = 16,
                   table_len: int = 64, n_stake_accts: int = 128, n_config_accts: int = 64,
                   n_ed25519: int = 256, n_secp256k1: int = 64, n_lookup_fail: int = 64,
                   n_alt: int = 2, seed: bytes = b"programs", payer_seed: bytes = b"benchg",
                   n_payers: int = 8, slot: int = PROGRAM_SLOT) -> ProgramStream:
    """A leader's program traffic, seeded and shuffled, with the genesis
    that lands it:

      - n_v0 v0 transfers from benchg's payers, each destination loaded
        through one of n_tables lookup tables of table_len addresses (the
        n_tables * table_len destinations of benchg's pool), every other
        one loading a readonly address of its table too;
      - n_legacy of benchg's transfers over the same destinations;
      - two stake txns on each of n_stake_accts stake accounts, in four
        groups by genesis state: uninitialized (initialize twice, one
        lands ok), initialized (delegate, and a delegate signed by an
        impostor), delegated (deactivate and split) and initialized again
        (two withdrawals);
      - two config stores on each of n_config_accts config accounts, the
        second one by an impostor on one account in 16;
      - n_ed25519 and n_secp256k1 precompile txns of one entry each, one in
        16 with a bad signature or a wrong address;
      - n_lookup_fail v0 transfers whose lookups fail: a missing table, an
        index past the table's length, a table past its deactivation
        cooldown;
      - n_alt of each lookup table instruction on tables of their own:
        create (its address the PDA of the authority and a recent slot),
        extend, freeze and deactivate.

    Each txn's outcome is known up front, whatever order pack lands them
    in, but for the raced initializations (`race`: one of each pair lands
    ok): `expect` counts the ok and failed txns of each kind."""
    from ..flamenco import alt, stake
    from ..flamenco import config_program as cfg
    from ..flamenco import precompiles as pc
    from ..flamenco.executor import acct_encode
    from ..ops import secp256k1 as secp
    from ..ops.keccak256 import keccak256_host
    from ..protocol import pda

    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(seed).digest()[:8], "little"))
    bh = pool_blockhash(payer_seed)
    payers = pool_payers(payer_seed, n_payers)
    n_dests = n_tables * table_len
    dests = [hashlib.sha256(payer_seed + b"to%d" % j).digest() for j in range(n_dests)]
    genesis = {pub: acct_encode(PAYER_LAMPORTS) for _, pub in payers}
    tables_gen, tables = alt_genesis(dests, table_len=table_len, seed=seed)
    genesis.update(tables_gen)
    kind, bad, race, credit, expect = {}, set(), set(), {}, {}

    def fund(tag: bytes) -> tuple[bytes, bytes]:
        key = _keyed(seed, tag)
        genesis[key[1]] = acct_encode(PAYER_LAMPORTS)
        return key

    def add(k: str, p: bytes, ok: bool, raced: bool = False) -> None:
        kind[p] = k
        if raced:
            race.add(p)
        elif not ok:
            bad.add(p)
        good, fail = expect.get(k, (0, 0))
        expect[k] = (good + ok, fail + (not ok))

    for i in range(n_v0):
        j = i % n_dests
        ro = (j + 1) % table_len if i % 2 and table_len > 1 else None
        p = v0_transfer(payers[i % n_payers], tables[j // table_len], j % table_len, 1 + i, bh, ro)
        credit[p] = (dests[j], 1 + i)
        add("v0", p, True)
    for i, p in enumerate(gen_transfer_pool(n_legacy, seed=payer_seed, n_payers=n_payers,
                                            n_dests=n_dests)):
        credit[p] = (dests[i % n_dests], 1 + i)
        add("legacy", p, True)

    # lookups that fail: a missing table, an index past the table's length,
    # a table deactivated past its cooldown
    expired = hashlib.sha256(seed + b"expired-table").digest()
    genesis[expired] = _lookup_table_value(
        None, dests[:4], deactivation_slot=slot - alt.DEACTIVATE_COOLDOWN_SLOTS - 2)
    for f in range(n_lookup_fail):
        table, idx = ((hashlib.sha256(seed + b"no-table%d" % f).digest(), 0),
                      (tables[f % n_tables], table_len + f % (256 - table_len)),
                      (expired, 0))[f % 3]
        add("lookup", v0_transfer(payers[f % n_payers], table, idx, 1 + n_v0 + f, bh), False)

    # stake: four groups of accounts by genesis state
    auths = [fund(b"stake-auth%d" % k) for k in range(8)]
    impostor = fund(b"impostor")
    votes = [hashlib.sha256(seed + b"stake-vote%d" % v).digest() for v in range(4)]
    sp = stake.STAKE_PROGRAM

    def stake_txn(signer, accts, data, **kw):
        return _program_txn(signer, sp, accts, data, bh, cu_limit=STAKE_CU_LIMIT, **kw)

    for s in range(n_stake_accts):
        key = hashlib.sha256(seed + b"stake%d" % s).digest()
        auth, group, vote = auths[s % 8], s % 4, votes[s % 4]
        if group == 0:
            st = stake.StakeState()
        elif group == 2:
            st = stake.StakeState(state=stake.STATE_DELEGATED, staker=auth[1],
                                  withdrawer=auth[1], voter=vote, stake=STAKE_LAMPORTS,
                                  activation_epoch=0)
        else:
            st = stake.StakeState(state=stake.STATE_INIT, staker=auth[1], withdrawer=auth[1])
        genesis[key] = acct_encode(STAKE_LAMPORTS, sp, data=st.encode())
        if group == 0:  # initialize twice: the first to land wins
            add("stake", stake_txn(auth, [key], _ix(0, auth[1] + auth[1])), True, True)
            add("stake", stake_txn(auth, [key], _ix(0, auth[1] + impostor[1])), False, True)
        elif group == 1:  # delegate; a delegate the staker did not sign
            add("stake", stake_txn(auth, [key, vote, auth[1]], _ix(1), readonly=(vote,)), True)
            add("stake", stake_txn(impostor, [key, vote, impostor[1]], _ix(1), readonly=(vote,)),
                False)
        elif group == 2:  # deactivate and split, in either order
            split = hashlib.sha256(seed + b"split%d" % s).digest()
            genesis[split] = acct_encode(0, sp, data=stake.StakeState().encode())
            add("stake", stake_txn(auth, [key, auth[1]], _ix(2)), True)
            add("stake", stake_txn(auth, [key, split, auth[1]],
                                   _ix(4, (1000 + s).to_bytes(8, "little"))), True)
        else:  # two withdrawals to the withdrawer
            for w in (1000, 2000):
                add("stake", stake_txn(auth, [key, auth[1], auth[1]],
                                       _ix(3, (w + s).to_bytes(8, "little"))), True)

    # config: two stores an account, the second by an impostor on 1 in 16
    cauths = [fund(b"config-auth%d" % k) for k in range(8)]
    for c in range(n_config_accts):
        key = hashlib.sha256(seed + b"config%d" % c).digest()
        auth = cauths[c % 8]
        genesis[key] = acct_encode(10**6, cfg.CONFIG_PROGRAM, data=cfg.build_keys(
            [(auth[1], True)], bytes(CONFIG_DATA_LEN - 35)))
        for n in range(2):
            signer = impostor if n == 1 and c % 16 == 15 else auth
            data = cfg.build_keys([(auth[1], True)], rng.bytes(32))
            add("config", _program_txn(signer, cfg.CONFIG_PROGRAM, [key, signer[1]], data, bh),
                signer is auth)

    # the precompiles: one entry a txn, 1 in 16 bad
    pc_payers = [fund(b"pc-payer%d" % k) for k in range(8)]
    ed_keys = [_keyed(seed, b"ed-signer%d" % k) for k in range(16)]
    for e in range(n_ed25519):
        msg = rng.bytes(int(rng.integers(16, 129)))
        sk, pk = ed_keys[e % 16]
        sig = ref.sign(sk, msg)
        ok = e % 16 != 15
        if not ok:
            sig = sig[:5] + bytes([sig[5] ^ 0x10]) + sig[6:]
        add("ed25519", _program_txn(pc_payers[e % 8], pc.ED25519_PROGRAM, [],
                                    pc.ed25519_entry_data(sig, pk, msg), bh), ok)
    secp_keys = []
    for k in range(4):
        d = int.from_bytes(hashlib.sha256(seed + b"secp%d" % k).digest(), "big") % secp.N
        x, y = secp.pubkey_of(d)
        secp_keys.append((d, secp.eth_address(x.to_bytes(32, "big") + y.to_bytes(32, "big"))))
    for e in range(n_secp256k1):
        msg = rng.bytes(int(rng.integers(16, 129)))
        d, eth = secp_keys[e % 4]
        sig, rec = secp.sign(d, keccak256_host(msg))
        ok = e % 16 != 15
        if not ok:
            eth = bytes([eth[0] ^ 0x01]) + eth[1:]
        add("secp256k1", _program_txn(pc_payers[e % 8], pc.SECP256K1_PROGRAM, [],
                                      pc.secp256k1_entry_data(sig, rec, eth, msg), bh), ok)

    # the lookup table program on tables of its own
    alt_auth = fund(b"alt-auth")
    ap = alt.ALT_PROGRAM
    for k in range(n_alt):
        recent = slot - 1 - k
        table, bump = pda.find_program_address([alt_auth[1], recent.to_bytes(8, "little")], ap)
        add("alt", _program_txn(alt_auth, ap, [table, alt_auth[1], alt_auth[1]],
                                _ix(0, recent.to_bytes(8, "little") + bytes([bump])), bh), True)
        new = [hashlib.sha256(seed + b"extended%d/%d" % (k, n)).digest() for n in range(2)]
        for t, name, tail in ((2, b"extend", (2).to_bytes(8, "little") + b"".join(new)),
                              (1, b"freeze", b""), (3, b"deactivate", b"")):
            table = hashlib.sha256(seed + b"alt-%s%d" % (name, k)).digest()
            genesis[table] = _lookup_table_value(alt_auth[1], dests[k : k + 2])
            add("alt", _program_txn(alt_auth, ap, [table, alt_auth[1]], _ix(t, tail), bh), True)

    stream = list(kind)
    stream = [stream[i] for i in rng.permutation(len(stream))]
    return ProgramStream(stream, kind, bad, race, credit, expect, genesis, slot, payer_seed)


def program_bank_ctx(ps: ProgramStream, *, device=None):
    """A BankCtx at ps.slot that lands `ps`: ps.genesis on the funk root and
    the payers' blockhash registered with the status cache."""
    from ..flamenco.blockstore import StatusCache
    from ..runtime.bank import BankCtx

    ctx = BankCtx(slot=ps.slot, status_cache=StatusCache(),
                  blockhashes=(pool_blockhash(ps.seed),), device=device)
    for pub, val in ps.genesis.items():
        ctx.funk.rec_insert(None, pub, val)
    return ctx


# -- sBPF programs: a small assembler and ELF writer --------------------------------------

# the opcodes the programs below use (the sBPF ISA's encoding)
OP_ADD64_IMM, OP_ADD64_REG, OP_MOV64_IMM, OP_MOV64_REG = 0x07, 0x0F, 0xB7, 0xBF
OP_LDXB, OP_LDXDW, OP_STB, OP_STW, OP_STXB, OP_STXDW = 0x71, 0x79, 0x72, 0x62, 0x73, 0x7B
OP_JA, OP_JEQ_IMM, OP_CALL, OP_EXIT, OP_LDDW = 0x05, 0x15, 0x85, 0x95, 0x18


def ins(opcode: int, dst: int = 0, src: int = 0, off: int = 0, imm: int = 0) -> bytes:
    """One 8-byte instruction slot: opcode, dst | src << 4, i16 off, i32 imm."""
    return (bytes([opcode, (src << 4) | dst]) + off.to_bytes(2, "little", signed=True)
            + (imm & 0xFFFFFFFF).to_bytes(4, "little"))


def lddw(dst: int, val: int) -> bytes:
    """lddw's two slots: the low 32 bits in the first, the high in the second."""
    return (ins(OP_LDDW, dst=dst, imm=val & 0xFFFFFFFF) + bytes(4)
            + ((val >> 32) & 0xFFFFFFFF).to_bytes(4, "little"))


def assemble(lines: list) -> bytes:
    """Text from a list of labels (str), ("lddw", dst, value) and
    (opcode, dst, src, off, imm) tuples, where a jump's off, or a
    bpf-to-bpf call's imm, may name a label."""
    pcs, pc = {}, 0
    for it in lines:
        if isinstance(it, str):
            pcs[it] = pc
        else:
            pc += 2 if it[0] == "lddw" else 1
    out, pc = bytearray(), 0
    for it in lines:
        if isinstance(it, str):
            continue
        if it[0] == "lddw":
            out += lddw(it[1], it[2])
            pc += 2
            continue
        op, dst, src, off, imm = it
        if isinstance(off, str):
            off = pcs[off] - pc - 1
        if isinstance(imm, str):
            imm = pcs[imm] - pc - 1
        out += ins(op, dst, src, off, imm)
        pc += 1
    return bytes(out)


def build_elf(text: bytes, *, machine: int = 247, entry_slot: int = 0, rodata: bytes = b"",
              rels=(), text_addr: int = 0x100) -> bytes:
    """A minimal little-endian ELF64 the sBPF loader takes: .text (at
    text_addr), an optional .rodata and .rel.dyn, and .shstrtab (the same
    layout as tests/test_sbpf.py's)."""
    import struct

    shstr = b"\x00.text\x00.rodata\x00.rel.dyn\x00.shstrtab\x00"
    n_text, n_ro, n_rel, n_shstr = 1, 7, 15, 24
    ehsz = 64
    text_off = ehsz
    ro_off = text_off + len(text)
    rel_bytes = b"".join(struct.pack("<QQ", off, info) for off, info in rels)
    rel_off = ro_off + len(rodata)
    str_off = rel_off + len(rel_bytes)
    shoff = str_off + len(shstr)

    def shdr(name, type_, flags, addr, off, size):
        return struct.pack("<IIQQQQIIQQ", name, type_, flags, addr, off, size, 0, 0, 0, 0)

    shdrs = [shdr(0, 0, 0, 0, 0, 0), shdr(n_text, 1, 0x6, text_addr, text_off, len(text))]
    if rodata:
        shdrs.append(shdr(n_ro, 1, 0x2, 0x1000, ro_off, len(rodata)))
    if rels:
        shdrs.append(shdr(n_rel, 9, 0, 0, rel_off, len(rel_bytes)))
    shstrndx = len(shdrs)
    shdrs.append(shdr(n_shstr, 3, 0, 0, str_off, len(shstr)))
    ehdr = struct.pack("<16sHHIQQQIHHHHHH", b"\x7fELF" + bytes([2, 1, 1]) + bytes(9), 3,
                       machine, 1, text_addr + 8 * entry_slot, 0, shoff, 0, ehsz, 0, 0,
                       struct.calcsize("<IIQQQQIIQQ"), len(shdrs), shstrndx)
    return bytes(ehdr) + text + rodata + rel_bytes + shstr + b"".join(shdrs)


@dataclass(frozen=True)
class InputLayout:
    """Where the aligned serialization (flamenco/executor.serialize_aligned)
    puts each instruction account's key and data, and the instruction
    data, as VM addresses, for distinct accounts of the given data lengths."""
    keys: tuple
    datas: tuple
    ix_data: int


def input_layout(data_lens: list[int]) -> InputLayout:
    from ..flamenco.executor import MAX_PERMITTED_DATA_INCREASE
    from ..flamenco.vm import MM_INPUT

    off, keys, datas = 8, [], []
    for n in data_lens:
        keys.append(MM_INPUT + off + 8)
        datas.append(MM_INPUT + off + 88)
        off += 88 + n + MAX_PERMITTED_DATA_INCREASE
        off += (-off) % 8 + 8
    return InputLayout(tuple(keys), tuple(datas), MM_INPUT + off + 8)


def _sys(name: str) -> int:
    from ..flamenco import vm as fvm

    return getattr(fvm, "SYSCALL_SOL_" + name)


COUNTER_LEN = 8   # a counter account's data: one u64
HASHER_LEN = 96   # a hasher account's data: the sha256, keccak256 and blake3 digests


def counter_text() -> bytes:
    """Counter: [counter w (8 bytes)], data u64 x: counter += x."""
    lay = input_layout([COUNTER_LEN])
    return assemble([
        ("lddw", 1, lay.datas[0]), (OP_LDXDW, 2, 1, 0, 0),
        ("lddw", 3, lay.ix_data), (OP_LDXDW, 4, 3, 0, 0),
        (OP_ADD64_REG, 2, 4, 0, 0), (OP_STXDW, 1, 2, 0, 0),
        (OP_MOV64_IMM, 0, 0, 0, 0), (OP_EXIT, 0, 0, 0, 0)])


def hasher_text() -> bytes:
    """Hasher: [hasher w (96 bytes)], data the bytes to hash: sha256,
    keccak256 and blake3 of the data into the account, sol_log_data of the
    sha256 digest, and the blake3 digest as return data."""
    lay = input_layout([HASHER_LEN])
    d = lay.datas[0]
    lines = [("lddw", 1, lay.ix_data), (OP_STXDW, 10, 1, -16, 0),       # SolBytes.addr
             ("lddw", 1, lay.ix_data - 8), (OP_LDXDW, 2, 1, 0, 0),
             (OP_STXDW, 10, 2, -8, 0)]                                  # SolBytes.len
    for k, name in enumerate(("SHA256", "KECCAK256", "BLAKE3")):
        lines += [(OP_MOV64_REG, 1, 10, 0, 0), (OP_ADD64_IMM, 1, 0, 0, -16),
                  (OP_MOV64_IMM, 2, 0, 0, 1), ("lddw", 3, d + 32 * k),
                  (OP_CALL, 0, 0, 0, _sys(name))]
    lines += [("lddw", 1, d), (OP_STXDW, 10, 1, -32, 0), (OP_MOV64_IMM, 1, 0, 0, 32),
              (OP_STXDW, 10, 1, -24, 0), (OP_MOV64_REG, 1, 10, 0, 0),
              (OP_ADD64_IMM, 1, 0, 0, -32), (OP_MOV64_IMM, 2, 0, 0, 1),
              (OP_CALL, 0, 0, 0, _sys("LOG_DATA")),
              ("lddw", 1, d + 64), (OP_MOV64_IMM, 2, 0, 0, 32),
              (OP_CALL, 0, 0, 0, _sys("SET_RETURN_DATA")),
              (OP_MOV64_IMM, 0, 0, 0, 0), (OP_EXIT, 0, 0, 0, 0)]
    return assemble(lines)


VAULT_SEED = b"vault"


def vault_data(lamports: int, k: int, bump: int, rust: bool) -> bytes:
    """Vault instruction data: u64 lamports | u8 vault index | u8 bump |
    u8 ABI (1 = sol_invoke_signed_rust) | the seed prefix."""
    return lamports.to_bytes(8, "little") + bytes([k, bump, int(rust)]) + VAULT_SEED


def vault_text() -> bytes:
    """Vault: [vault w, destination w, system program], data vault_data:
    the system program's transfer of `lamports` from the vault (a PDA of
    this program over [VAULT_SEED, k] and its bump) to the destination,
    by sol_invoke_signed_c, or sol_invoke_signed_rust when the ABI byte
    is 1, signed by the seeds in the data."""
    lay = input_layout([0, 0, 0])
    x = lay.ix_data
    seeds = [(x + 11, len(VAULT_SEED)), (x + 8, 1), (x + 9, 1)]

    def stack_addr(reg: int, off: int) -> list:
        return [(OP_MOV64_REG, reg, 10, 0, 0), (OP_ADD64_IMM, reg, 0, 0, off)]

    def invoke(instr_off: int, name: str) -> list:
        # invoke(&instr, no account infos, 0, &seeds, 1)
        return (stack_addr(1, instr_off) + [(OP_MOV64_IMM, 2, 0, 0, 0), (OP_MOV64_IMM, 3, 0, 0, 0)]
                + stack_addr(4, -248) + [(OP_MOV64_IMM, 5, 0, 0, 1),
                                         (OP_CALL, 0, 0, 0, _sys(name))])

    def copy32(src_addr: int, dst_off: int) -> list:
        out = [("lddw", 2, src_addr)]
        for w in range(4):
            out += [(OP_LDXDW, 3, 2, 8 * w, 0), (OP_STXDW, 10, 3, dst_off + 8 * w, 0)]
        return out

    # the transfer's data (u32 2 | u64 lamports) at -136
    lines = [(OP_STW, 10, 0, -136, 2),
             ("lddw", 1, x), (OP_LDXDW, 2, 1, 0, 0), (OP_STXDW, 10, 2, -132, 0)]
    for j, (addr, n) in enumerate(seeds):  # SolSignerSeedC[3] at -300
        lines += [("lddw", 2, addr), (OP_STXDW, 10, 2, -300 + 16 * j, 0),
                  (OP_MOV64_IMM, 2, 0, 0, n), (OP_STXDW, 10, 2, -292 + 16 * j, 0)]
    lines += stack_addr(2, -300) + [  # SolSignerSeedsC[1] at -248
        (OP_STXDW, 10, 2, -248, 0), (OP_MOV64_IMM, 2, 0, 0, 3), (OP_STXDW, 10, 2, -240, 0),
        (OP_LDXB, 3, 1, 10, 0), (OP_JEQ_IMM, 3, 0, "rust", 1)]
    # C ABI: SolAccountMeta[2] {u64 key addr, u8 writable, u8 signer} at -96,
    # SolInstruction {program id addr, metas, 2, data, 12} at -48
    for j, signer in enumerate((1, 0)):
        lines += [("lddw", 2, lay.keys[j]), (OP_STXDW, 10, 2, -96 + 10 * j, 0),
                  (OP_STB, 10, 0, -88 + 10 * j, 1), (OP_STB, 10, 0, -87 + 10 * j, signer)]
    lines += [("lddw", 2, lay.keys[2]), (OP_STXDW, 10, 2, -48, 0)]
    lines += stack_addr(2, -96) + [(OP_STXDW, 10, 2, -40, 0), (OP_MOV64_IMM, 2, 0, 0, 2),
                                   (OP_STXDW, 10, 2, -32, 0)]
    lines += stack_addr(2, -136) + [(OP_STXDW, 10, 2, -24, 0), (OP_MOV64_IMM, 2, 0, 0, 12),
                                    (OP_STXDW, 10, 2, -16, 0)]
    lines += invoke(-48, "INVOKE_SIGNED_C") + [(OP_JA, 0, 0, "done", 0), "rust"]
    # Rust ABI: AccountMeta[2] {key, u8 signer, u8 writable} at -232,
    # StableInstruction {metas vec, data vec, program id} at -96
    for j, signer in enumerate((1, 0)):
        base = -232 + 34 * j
        lines += copy32(lay.keys[j], base) + [(OP_STB, 10, 0, base + 32, signer),
                                              (OP_STB, 10, 0, base + 33, 1)]
    lines += stack_addr(2, -232) + [(OP_STXDW, 10, 2, -96, 0), (OP_MOV64_IMM, 2, 0, 0, 2),
                                    (OP_STXDW, 10, 2, -88, 0), (OP_STXDW, 10, 2, -80, 0)]
    lines += stack_addr(2, -136) + [(OP_STXDW, 10, 2, -72, 0), (OP_MOV64_IMM, 2, 0, 0, 12),
                                    (OP_STXDW, 10, 2, -64, 0), (OP_STXDW, 10, 2, -56, 0)]
    lines += copy32(lay.keys[2], -48) + invoke(-96, "INVOKE_SIGNED_RUST")
    lines += ["done", (OP_MOV64_IMM, 0, 0, 0, 0), (OP_EXIT, 0, 0, 0, 0)]
    return assemble(lines)


# the fail program's modes: each fails its txn typed, fee charged
FAIL_CUSTOM, FAIL_LOOP, FAIL_READONLY, FAIL_FAULT = 0, 1, 2, 3
FAIL_CUSTOM_CODE = 0x1771


def fail_text() -> bytes:
    """Fail: [counter (read-only)], data u8 mode | anything: mode 0 returns
    FAIL_CUSTOM_CODE, 1 loops until the budget runs out, 2 writes the
    read-only counter's image, 3 loads from address 0 (outside every
    region)."""
    lay = input_layout([COUNTER_LEN])
    return assemble([
        ("lddw", 1, lay.ix_data), (OP_LDXB, 2, 1, 0, 0),
        (OP_JEQ_IMM, 2, 0, "custom", FAIL_CUSTOM), (OP_JEQ_IMM, 2, 0, "loop", FAIL_LOOP),
        (OP_JEQ_IMM, 2, 0, "readonly", FAIL_READONLY),
        (OP_MOV64_IMM, 3, 0, 0, 0), (OP_LDXDW, 0, 3, 0, 0), (OP_EXIT, 0, 0, 0, 0),
        "custom", (OP_MOV64_IMM, 0, 0, 0, FAIL_CUSTOM_CODE), (OP_EXIT, 0, 0, 0, 0),
        "loop", (OP_JA, 0, 0, "loop", 0),
        "readonly", ("lddw", 1, lay.datas[0]), (OP_STB, 1, 0, 0, 1),
        (OP_MOV64_IMM, 0, 0, 0, 0), (OP_EXIT, 0, 0, 0, 0)])


# -- sBPF program traffic: the programs above under both BPF loaders --------------------------

SBPF_SLOT = PROGRAM_SLOT   # the sBPF leader's slot
SBPF_DEPLOY_SLOT = SBPF_SLOT - 100  # the genesis programs' deploy slot: before the run's
VAULT_LAMPORTS = 10**12    # each PDA vault
# the compute-unit limit each program's txns request, near what they use (the
# compute-budget instruction's 150 CU included); the fail program's loop runs
# until its request is spent
SBPF_CU = dict(counter=200, hasher=1200, vault=1500, fail=1000)
# the fail program's modes by kind, and the vault's escalation
FAIL_KINDS = dict(custom=FAIL_CUSTOM, budget=FAIL_LOOP, readonly=FAIL_READONLY,
                  fault=FAIL_FAULT)
LOADER_TAGS = ("initialize", "write", "deploy", "upgrade", "set_authority", "close")


def _keys(seed: bytes, tag: bytes) -> bytes:
    return hashlib.sha256(seed + tag).digest()


def sbpf_programs(seed: bytes = b"sbpf") -> dict:
    """name -> (program id, ELF): counter and fail under loader v2, hasher
    and vault under the upgradeable loader."""
    return {name: (_keys(seed, b"%s-program" % name.encode()), build_elf(fn()))
            for name, fn in (("counter", counter_text), ("fail", fail_text),
                             ("hasher", hasher_text), ("vault", vault_text))}


def sbpf_genesis(*, n_counters: int = 64, n_hashers: int = 16, n_vaults: int = 16,
                 seed: bytes = b"sbpf") -> tuple[dict, dict]:
    """({pubkey: account value}, accounts): the four programs (loader-v2
    accounts holding their ELF; upgradeable program accounts with their
    programdata, deployed at SBPF_DEPLOY_SLOT under an authority), the
    counter accounts (a seeded u64 each), the hasher accounts (96 zero
    bytes) and the vaults (funded system accounts at the vault program's
    PDAs over [VAULT_SEED, k]).  `accounts` names them: programs, counters
    ({key: first value}), hashers, vaults ([(key, bump)]) and the
    authority."""
    from ..flamenco import bpf_loader as bl
    from ..flamenco.executor import BPF_LOADER_PROGRAM, acct_encode
    from ..protocol import pda

    progs = sbpf_programs(seed)
    auth = _keyed(seed, b"upgrade-authority")
    genesis = {}
    for name, (key, elf) in progs.items():
        if name in ("counter", "fail"):
            genesis[key] = acct_encode(1, BPF_LOADER_PROGRAM, True, elf)
            continue
        pd, _ = pda.find_program_address([key], bl.UPGRADEABLE_LOADER_PROGRAM)
        genesis[key] = acct_encode(1, bl.UPGRADEABLE_LOADER_PROGRAM, True, bl.program_encode(pd))
        genesis[pd] = acct_encode(1, bl.UPGRADEABLE_LOADER_PROGRAM, False,
                                  bl.programdata_encode(SBPF_DEPLOY_SLOT, auth[1], elf))
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(seed).digest()[:8], "little"))
    counters = {}
    for c in range(n_counters):
        key = _keys(seed, b"counter%d" % c)
        counters[key] = int(rng.integers(0, 2**32))
        genesis[key] = acct_encode(10**6, progs["counter"][0],
                                   data=counters[key].to_bytes(COUNTER_LEN, "little"))
    hashers = [_keys(seed, b"hasher%d" % h) for h in range(n_hashers)]
    for key in hashers:
        genesis[key] = acct_encode(10**6, progs["hasher"][0], data=bytes(HASHER_LEN))
    vaults = [pda.find_program_address([VAULT_SEED, bytes([k])], progs["vault"][0])
              for k in range(n_vaults)]
    for key, _bump in vaults:
        genesis[key] = acct_encode(VAULT_LAMPORTS)
    return genesis, dict(programs=progs, counters=counters, hashers=hashers, vaults=vaults,
                         authority=auth)


@dataclass
class SbpfStream:
    stream: list    # frames in send order
    kind: dict      # payload -> "legacy", "counter", "hasher", "vault", a FAIL_KINDS
    #                 key, "escalation" or "loader"
    bad: set        # payloads built to fail typed (fee charged)
    rust: set       # vault payloads that invoke through sol_invoke_signed_rust
    credit: dict    # payload -> [(pubkey, lamport delta)] when it lands ok
    counter_ops: dict  # counter payload -> (counter, operand)
    hasher_ops: dict   # hasher payload -> (hasher account, the data hashed)
    loader_expect: dict  # pubkey -> (lamports, owner, executable, data) once the loader txns land
    accounts: dict  # sbpf_genesis's names
    expect: dict    # kind -> (txns that must land ok, txns that must fail)
    genesis: dict   # pubkey -> account value, the fee payers included
    slot: int
    seed: bytes     # the legacy payers' benchg seed (payers, blockhash)


def sbpf_stream(*, n_legacy: int = 5040, n_counter: int = 2048, n_hasher: int = 512,
                n_vault: int = 512, n_vault_rust: int = 64, n_fail: int = 64, n_loader: int = 16,
                n_counters: int = 64, n_hashers: int = 16, n_vaults: int = 16,
                n_dests: int = 1024, n_sbpf_payers: int = 64, seed: bytes = b"sbpf",
                payer_seed: bytes = b"benchg", n_payers: int = 8,
                slot: int = SBPF_SLOT) -> SbpfStream:
    """A leader's on-chain program traffic, seeded and shuffled, with the
    genesis (sbpf_genesis's, the payers funded) that lands it:

      - n_legacy of benchg's transfers over n_dests destinations;
      - n_counter counter invocations (distinct operands) over the
        counters, n_hasher hasher invocations (64-256 random bytes) over
        the hasher accounts, and n_vault vault transfers from the PDA
        vaults to the destinations, n_vault_rust of them through the Rust
        ABI, each behind a SetComputeUnitLimit of SBPF_CU, paid by
        n_sbpf_payers payers of their own;
      - n_fail of each typed failure: the fail program's custom error, CU
        exhaustion, read-only image write and fault, and a vault transfer
        signed by another vault's seeds (a CPI signer escalation);
      - n_loader upgradeable-loader txns on fresh accounts of their own,
        cycling over LOADER_TAGS, each independent of the others, so that
        their accounts' final bytes (loader_expect) hold in any order.

    Every outcome is known up front, whatever order pack lands them in."""
    from ..flamenco import bpf_loader as bl
    from ..flamenco.executor import acct_encode
    from ..protocol import pda

    ldr = bl.UPGRADEABLE_LOADER_PROGRAM
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(seed + b"stream").digest()[:8],
                                               "little"))
    bh = pool_blockhash(payer_seed)
    genesis, accts = sbpf_genesis(n_counters=n_counters, n_hashers=n_hashers,
                                  n_vaults=n_vaults, seed=seed)
    progs = accts["programs"]
    for _, pub in pool_payers(payer_seed, n_payers):
        genesis[pub] = acct_encode(PAYER_LAMPORTS)
    payers = [_keyed(seed, b"payer%d" % k) for k in range(n_sbpf_payers)]
    for _, pub in payers:
        genesis[pub] = acct_encode(PAYER_LAMPORTS)
    dests = [hashlib.sha256(payer_seed + b"to%d" % j).digest() for j in range(n_dests)]
    counters = list(accts["counters"])
    ss = SbpfStream([], {}, set(), set(), {}, {}, {}, {}, accts, {}, genesis, slot, payer_seed)

    def add(k: str, p: bytes, ok: bool) -> None:
        ss.kind[p] = k
        if not ok:
            ss.bad.add(p)
        good, fail = ss.expect.get(k, (0, 0))
        ss.expect[k] = (good + ok, fail + (not ok))

    def call(i: int, name: str, ix_accts: list, data: bytes, readonly=()) -> bytes:
        return _program_txn(payers[i % n_sbpf_payers], progs[name][0], ix_accts, data, bh,
                            readonly=readonly, cu_limit=SBPF_CU[name])

    for i, p in enumerate(gen_transfer_pool(n_legacy, seed=payer_seed, n_payers=n_payers,
                                            n_dests=n_dests)):
        ss.credit[p] = [(dests[i % n_dests], 1 + i)]
        add("legacy", p, True)
    for i in range(n_counter):
        c = counters[i % len(counters)]
        p = call(i, "counter", [c], (1 + i).to_bytes(8, "little"))
        ss.counter_ops[p] = (c, 1 + i)
        add("counter", p, True)
    for i in range(n_hasher):
        h = accts["hashers"][i % n_hashers]
        data = rng.bytes(int(rng.integers(64, 257)))
        p = call(i, "hasher", [h], data)
        ss.hasher_ops[p] = (h, data)
        add("hasher", p, True)
    vaults = accts["vaults"]
    for i in range(n_vault + n_fail):
        k, dest, lam = i % n_vaults, dests[(7 * i) % n_dests], 1 + i
        rust = i < n_vault_rust
        ok = i < n_vault
        ks = k if ok else (k + 1) % n_vaults  # an escalation signs with vault k + 1's seeds
        p = call(i, "vault", [vaults[k][0], dest, ft.SYSTEM_PROGRAM],
                 vault_data(lam, ks, vaults[ks][1], rust), readonly=(ft.SYSTEM_PROGRAM,))
        if ok:
            ss.credit[p] = [(dest, lam), (vaults[k][0], -lam)]
            if rust:
                ss.rust.add(p)
        add("vault" if ok else "escalation", p, ok)
    for kind, mode in FAIL_KINDS.items():
        for i in range(n_fail):
            c = counters[(i + 17 * mode) % len(counters)]
            add(kind, call(i + mode, "fail", [c], bytes([mode]) + i.to_bytes(4, "little"),
                           readonly=(c,)), False)

    # the upgradeable loader on accounts of each txn's own
    lpayer = _keyed(seed, b"loader-payer")
    genesis[lpayer[1]] = acct_encode(PAYER_LAMPORTS)
    a = lpayer[1]
    elf, new_elf = progs["counter"][1], progs["fail"][1]
    room = 256
    for i in range(n_loader):
        tag = LOADER_TAGS[i % len(LOADER_TAGS)]
        buf = _keys(seed, b"loader-buffer%d" % i)
        exp = ss.loader_expect
        if tag == "initialize":
            genesis[buf] = acct_encode(10**6, ldr, data=bytes(bl.BUFFER_META_SIZE + room))
            p = _program_txn(lpayer, ldr, [buf, a], _ix(0), bh)
            exp[buf] = (10**6, ldr, False, bl.buffer_encode(a) + bytes(room))
        elif tag == "write":
            genesis[buf] = acct_encode(10**6, ldr, data=bl.buffer_encode(a) + bytes(room))
            chunk = rng.bytes(32)
            p = _program_txn(lpayer, ldr, [buf, a], _ix(1, (8).to_bytes(4, "little")
                                                         + len(chunk).to_bytes(8, "little")
                                                         + chunk), bh)
            exp[buf] = (10**6, ldr, False, bl.buffer_encode(a) + bytes(8) + chunk
                        + bytes(room - 8 - len(chunk)))
        elif tag == "deploy":
            prog = _keys(seed, b"loader-program%d" % i)
            pd, _ = pda.find_program_address([prog], ldr)
            genesis[buf] = acct_encode(10**6, ldr, data=bl.buffer_encode(a, elf))
            genesis[prog] = acct_encode(10**6, ldr, data=bytes(bl.PROGRAM_SIZE))
            p = _program_txn(lpayer, ldr, [a, pd, prog, buf, a],
                             _ix(2, (len(elf) + room).to_bytes(8, "little")), bh)
            exp[pd] = (0, ldr, False, bl.programdata_encode(slot, a, elf) + bytes(room))
            exp[prog] = (10**6, ldr, True, bl.program_encode(pd))
            exp[buf] = (0, ft.SYSTEM_PROGRAM, False, b"")
        elif tag == "upgrade":
            prog = _keys(seed, b"loader-program%d" % i)
            pd, _ = pda.find_program_address([prog], ldr)
            genesis[prog] = acct_encode(10**6, ldr, True, bl.program_encode(pd))
            genesis[pd] = acct_encode(10**6, ldr, data=bl.programdata_encode(
                SBPF_DEPLOY_SLOT, a, elf) + bytes(room))
            genesis[buf] = acct_encode(10**6, ldr, data=bl.buffer_encode(a, new_elf))
            p = _program_txn(lpayer, ldr, [pd, prog, buf, a, a], _ix(3), bh)
            exp[pd] = (10**6, ldr, False, bl.programdata_encode(slot, a, new_elf)
                       + bytes(len(elf) + room - len(new_elf)))
            exp[buf] = (0, ft.SYSTEM_PROGRAM, False, b"")
        elif tag == "set_authority":
            new = _keys(seed, b"loader-new-authority%d" % i)
            payload = rng.bytes(64)
            genesis[buf] = acct_encode(10**6, ldr, data=bl.buffer_encode(a, payload))
            p = _program_txn(lpayer, ldr, [buf, a, new], _ix(4), bh, readonly=(new,))
            exp[buf] = (10**6, ldr, False, bl.buffer_encode(new, payload))
        else:  # close
            genesis[buf] = acct_encode(10**6, ldr, data=bl.buffer_encode(a, rng.bytes(64)))
            p = _program_txn(lpayer, ldr, [buf, a, a], _ix(5), bh)
            exp[buf] = (0, ft.SYSTEM_PROGRAM, False, b"")
        add("loader", p, True)

    stream = list(ss.kind)
    ss.stream = [stream[i] for i in rng.permutation(len(stream))]
    return ss


def sbpf_bank_ctx(ss: SbpfStream, *, device=None):
    """A BankCtx at ss.slot that lands `ss`: ss.genesis on the funk root and
    the payers' blockhash registered with the status cache."""
    from ..flamenco.blockstore import StatusCache
    from ..runtime.bank import BankCtx

    ctx = BankCtx(slot=ss.slot, status_cache=StatusCache(),
                  blockhashes=(pool_blockhash(ss.seed),), device=device)
    for pub, val in ss.genesis.items():
        ctx.funk.rec_insert(None, pub, val)
    return ctx


# -- zk-elgamal proof traffic ---------------------------------------------------------------

ZK_SLOT = 1
# each zk txn's SetComputeUnitLimit: its instruction's charge
# (zk_elgamal.INSTR_COMPUTE_UNITS) plus this, which covers the compute-budget
# instruction's own 150; pack does not price the zk program as a builtin, so
# a zk txn with no request costs 200,000 CU a zk instruction in pack
ZK_CU_MARGIN = 1000
# the creations' SetComputeUnitPrice (micro-lamports a CU): each creation
# ranks above its own close in pack's order (both write the context account)
ZK_CREATE_CU_PRICE = 1_000_000
ZK_STATE_LAMPORTS = 10**6   # each context-state account


@dataclass
class ZkStream:
    stream: list    # frames in send order
    kind: dict      # payload -> "legacy", "pubkey_validity", "zero_ciphertext",
    #                 "from_account", "context_create", "context_close", "range_u64",
    #                 "range_u128", "range_u256", "tampered", "wrong_size",
    #                 "wrong_authority" or "no_cu_request"
    bad: set        # payloads built to fail typed (fee charged)
    expect: dict    # kind -> (txns that must land ok, txns that must fail)
    accounts_expect: dict  # pubkey -> (lamports, owner, executable, data) once all land
    genesis: dict   # pubkey -> account value, the fee payers included
    slot: int
    seed: bytes     # the legacy payers' benchg seed (payers, blockhash)


def zk_proofs(seed: bytes = b"zk") -> dict:
    """One proof of each kind the zk stream sends, made with the port's own
    provers (sigma.prove_pubkey_validity, sigma.prove_zero_ciphertext,
    rangeproof.prove_range): {kind: (tag, context, proof)}, kinds
    "pubkey_validity", "zero_ciphertext", "range_u64", "range_u128" and
    "range_u256" (commitments of 64 bits each, one, two and four of
    them)."""
    from ..flamenco.zksdk import elgamal as eg
    from ..flamenco.zksdk import rangeproof as rp
    from ..flamenco.zksdk import sigma
    from ..flamenco.zksdk.merlin import Transcript

    def scalar(tag: bytes) -> int:
        return int.from_bytes(hashlib.sha512(seed + tag).digest(), "little") % L

    s, pub = eg.keygen(seed + b"key")
    out = {"pubkey_validity": (4, pub, sigma.prove_pubkey_validity(s, pub, seed + b"pkv"))}
    ct = eg.encrypt(pub, 0, scalar(b"zero-r"))
    out["zero_ciphertext"] = (1, pub + ct, sigma.prove_zero_ciphertext(s, pub, ct, seed + b"zc"))
    for kind, tag, n in (("range_u64", 6, 1), ("range_u128", 7, 2), ("range_u256", 8, 4)):
        amounts = [int.from_bytes(hashlib.sha256(seed + b"amt%d/%d" % (n, j)).digest()[:8],
                                  "little") for j in range(n)]
        blinds = [scalar(b"blind%d/%d" % (n, j)) for j in range(n)]
        comms = b"".join(eg.commit(a, r) for a, r in zip(amounts, blinds)).ljust(8 * 32, b"\0")
        context = comms + bytes([64] * n).ljust(8, b"\0")
        t = Transcript(b"batched-range-proof-instruction")
        t.append_message(b"commitments", context[: 8 * 32])
        t.append_message(b"bit-lengths", context[8 * 32 :])
        proof = rp.prove_range(amounts, blinds, [64] * n, t, seed + kind.encode())
        out[kind] = (tag, context, proof)
    return out


def zk_stream(*, n_legacy: int = 6000, n_pubkey_validity: int = 512, n_zero_ciphertext: int = 512,
              n_from_account: int = 64, n_context: int = 64, n_range_u64: int = 8,
              n_range_u128: int = 4, n_range_u256: int = 2, n_fail: int = 64,
              n_holders: int = 8, n_dests: int = 1024, n_zk_payers: int = 64, seed: bytes = b"zk",
              payer_seed: bytes = b"benchg", n_payers: int = 8, slot: int = ZK_SLOT,
              proofs: dict | None = None) -> ZkStream:
    """A leader's zk-elgamal proof traffic (what wallets and token programs
    post for Token-2022's confidential transfers), seeded and shuffled, with
    the genesis that lands it:

      - n_legacy of benchg's transfers over n_dests destinations;
      - n_pubkey_validity and n_zero_ciphertext verifies inline;
      - n_from_account verifies whose proof data an account holds at a u32
        offset (n_holders accounts, both sigma kinds);
      - n_context context-state creations (a verify that writes its context
        into a program-owned account, the payer its authority), and their
        n_context CloseContextStates, sent after every other txn, to a
        destination of their own;
      - n_range_u64 and n_range_u128 range verifies inline, and n_range_u256
        from an account (its instruction would pass the txn MTU inline);
      - n_fail of each typed failure: a tampered proof, an instruction of the
        wrong size, a CloseContextState signed by another than the context's
        authority, and a u256 range verify with no CU request (its 368,000
        CU charge passes the default 200,000 budget).

    One proof of each kind (zk_proofs, or `proofs`) serves every txn of its
    kind; the txns differ in payer (n_zk_payers of their own) and CU limit.
    Every zk txn but the no-request failures carries a SetComputeUnitLimit
    of its charge plus ZK_CU_MARGIN plus its serial number, and every
    creation a priority fee (ZK_CREATE_CU_PRICE), so that pack lands it
    before its own close.  Every outcome is known up front."""
    from ..flamenco import zk_elgamal as zk
    from ..flamenco.executor import acct_encode

    zp = zk.ZK_ELGAMAL_PROOF_PROGRAM
    proofs = proofs or zk_proofs(seed)
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(seed + b"stream").digest()[:8],
                                               "little"))
    bh = pool_blockhash(payer_seed)
    genesis = {pub: acct_encode(PAYER_LAMPORTS) for _, pub in pool_payers(payer_seed, n_payers)}
    payers = [_keyed(seed, b"payer%d" % k) for k in range(n_zk_payers)]
    for _, pub in payers:
        genesis[pub] = acct_encode(PAYER_LAMPORTS)
    kind, bad, expect, acct_exp = {}, set(), {}, {}
    n_txn = [0]

    def add(k: str, p: bytes, ok: bool) -> None:
        kind[p] = k
        if not ok:
            bad.add(p)
        good, fail = expect.get(k, (0, 0))
        expect[k] = (good + ok, fail + (not ok))

    def payer() -> tuple[bytes, bytes]:
        n_txn[0] += 1
        return payers[n_txn[0] % n_zk_payers]

    def zk_txn(tag: int, data: bytes, accts=(), readonly=(), signer=None, **kw) -> bytes:
        """A zk txn whose CU limit is its charge, the margin and a serial
        number (so that txns of one proof and one payer differ)."""
        signer = signer or payer()
        limit = zk.INSTR_COMPUTE_UNITS[tag] + ZK_CU_MARGIN + n_txn[0]
        return _program_txn(signer, zp, list(accts), bytes([tag]) + data, bh,
                            readonly=tuple(readonly), cu_limit=limit, **kw)

    for p in gen_transfer_pool(n_legacy, seed=payer_seed, n_payers=n_payers, n_dests=n_dests):
        add("legacy", p, True)
    for k, n in (("pubkey_validity", n_pubkey_validity), ("zero_ciphertext", n_zero_ciphertext),
                 ("range_u64", n_range_u64), ("range_u128", n_range_u128)):
        tag, context, proof = proofs[k]
        for _ in range(n):
            add(k, zk_txn(tag, context + proof), True)

    # proof data in accounts: each holder holds both sigma kinds' blobs at
    # an offset of its own, then the u256 range blob
    sig_kinds = ("pubkey_validity", "zero_ciphertext")
    holders, offsets = [], []
    for h in range(n_holders):
        key = hashlib.sha256(seed + b"holder%d" % h).digest()
        blob, offs = bytes(3 + 5 * h), {}
        for k in sig_kinds + ("range_u256",):
            offs[k] = len(blob)
            blob += proofs[k][1] + proofs[k][2]
        genesis[key] = acct_encode(10**6, data=blob)
        holders.append(key)
        offsets.append(offs)
    for f in range(n_from_account):
        h, k = f % n_holders, sig_kinds[f % 2]
        add("from_account", zk_txn(proofs[k][0], offsets[h][k].to_bytes(4, "little"),
                                   [holders[h]], readonly=[holders[h]]), True)
    for f in range(n_range_u256):
        h = f % n_holders
        add("range_u256", zk_txn(8, offsets[h]["range_u256"].to_bytes(4, "little"),
                                 [holders[h]], readonly=[holders[h]]), True)

    # context states: created by a verify, closed after every other txn
    closes = []
    for c in range(n_context):
        tag, context, proof = proofs[sig_kinds[c % 2]]
        state = hashlib.sha256(seed + b"state%d" % c).digest()
        dest = hashlib.sha256(seed + b"close-dest%d" % c).digest()
        genesis[state] = acct_encode(ZK_STATE_LAMPORTS, zp,
                                     data=bytes(zk.CTX_HEAD_SZ + len(context)))
        signer = payer()  # pays the close too: the context's authority
        add("context_create", zk_txn(tag, context + proof, [state, signer[1]], signer=signer,
                                     cu_price=ZK_CREATE_CU_PRICE), True)
        p = _program_txn(signer, zp, [state, dest, signer[1]], bytes([0]), bh,
                         cu_limit=zk.INSTR_COMPUTE_UNITS[0] + ZK_CU_MARGIN)
        kind[p] = "context_close"
        closes.append(p)
        acct_exp[state] = (0, ft.SYSTEM_PROGRAM, False, b"")
        acct_exp[dest] = (ZK_STATE_LAMPORTS, ft.SYSTEM_PROGRAM, False, b"")
    expect["context_close"] = (len(closes), 0)

    # the typed failures
    tag, context, proof = proofs["pubkey_validity"]
    for f in range(n_fail):
        j = f % len(proof)
        add("tampered", zk_txn(tag, context + proof[:j] + bytes([proof[j] ^ 1 << f % 8])
                               + proof[j + 1 :]), False)
        add("wrong_size", zk_txn(tag, (context + proof)[: -1 - f % 8]), False)
        state = hashlib.sha256(seed + b"held-state%d" % f).digest()
        owner = hashlib.sha256(seed + b"held-owner%d" % f).digest()
        held = acct_encode(ZK_STATE_LAMPORTS, zp, data=owner + bytes([tag]) + context)
        genesis[state] = held
        acct_exp[state] = (ZK_STATE_LAMPORTS, zp, False, owner + bytes([tag]) + context)
        signer = payer()
        add("wrong_authority", _program_txn(signer, zp, [state, signer[1], signer[1]], bytes([0]),
                                            bh, cu_limit=zk.INSTR_COMPUTE_UNITS[0] + ZK_CU_MARGIN),
            False)
        # no CU request: each (payer, holder) pair once, so no two are alike
        h = (f // n_zk_payers) % n_holders
        data = bytes([8]) + offsets[h]["range_u256"].to_bytes(4, "little")
        add("no_cu_request", _program_txn(payers[f % n_zk_payers], zp, [holders[h]], data, bh,
                                          readonly=(holders[h],)), False)

    stream = [p for p in kind if kind[p] != "context_close"]
    stream = [stream[i] for i in rng.permutation(len(stream))]
    stream += [closes[i] for i in rng.permutation(len(closes))]
    return ZkStream(stream, kind, bad, expect, acct_exp, genesis, slot, payer_seed)


def zk_bank_ctx(zs: ZkStream, *, device=None):
    """A BankCtx at zs.slot that lands `zs`: zs.genesis on the funk root and
    the payers' blockhash registered with the status cache."""
    from ..flamenco.blockstore import StatusCache
    from ..runtime.bank import BankCtx

    ctx = BankCtx(slot=zs.slot, status_cache=StatusCache(),
                  blockhashes=(pool_blockhash(zs.seed),), device=device)
    for pub, val in zs.genesis.items():
        ctx.funk.rec_insert(None, pub, val)
    return ctx
