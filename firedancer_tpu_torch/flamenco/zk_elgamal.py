"""The ZK ElGamal proof program (the port's copy of
firedancer_tpu/flamenco/zk_elgamal.py).

Capability parity target: the reference's fd_zk_elgamal_proof_program.c
+ zksdk/fd_zksdk.c (Agave's programs/zk-elgamal-proof).  No code shared:
instruction dispatch, proof-data sourcing (instruction data or an
account at an offset), context-state account creation, and
CloseContextState are implemented from the program's documented
behavior over the zksdk modules (sigma proofs, bulletproof range
proofs, merlin transcripts, twisted ElGamal over ristretto255).

Instructions (u8 tag):
    0  CloseContextState
    1  VerifyZeroCiphertext
    2  VerifyCiphertextCiphertextEquality
    3  VerifyCiphertextCommitmentEquality
    4  VerifyPubkeyValidity
    5  VerifyPercentageWithCap
    6  VerifyBatchedRangeProofU64
    7  VerifyBatchedRangeProofU128
    8  VerifyBatchedRangeProofU256
    9  VerifyGroupedCiphertext2HandlesValidity
    10 VerifyBatchedGroupedCiphertext2HandlesValidity
    11 VerifyGroupedCiphertext3HandlesValidity
    12 VerifyBatchedGroupedCiphertext3HandlesValidity

A Verify* instruction takes its context+proof either inline
(data = tag || context || proof) or from account 0's data at a u32
offset (data = tag || u32 offset).  If extra accounts follow, the
verified CONTEXT is written into a proof-context-state account
(authority pubkey 32 | proof_type u8 | context), owned by this program,
closeable later via CloseContextState.
"""

from __future__ import annotations

from ..protocol.base58 import b58_decode32

ZK_ELGAMAL_PROOF_PROGRAM = b58_decode32(
    "ZkE1Gama1Proof11111111111111111111111111111"
)

CTX_HEAD_SZ = 33  # authority pubkey + proof_type byte

# per-instruction CU charges (the protocol's fixed builtin costs —
# reference fd_zk_elgamal_proof_program.h FD_ZKSDK_INSTR_*_COMPUTE_UNITS)
INSTR_COMPUTE_UNITS = {
    0: 3_300,
    1: 6_000,
    2: 8_000,
    3: 6_400,
    4: 2_600,
    5: 6_500,
    6: 111_000,
    7: 200_000,
    8: 368_000,
    9: 6_400,
    10: 13_000,
    11: 8_100,
    12: 16_400,
}

# tag -> (context size, proof size, verifier)


def _sizes():
    from .zksdk import sigma

    return {
        1: (96, 96, sigma.verify_zero_ciphertext),
        2: (192, 224, sigma.verify_ciphertext_ciphertext_equality),
        3: (128, 192, sigma.verify_ciphertext_commitment_equality),
        4: (32, 64, sigma.verify_pubkey_validity),
        5: (104, 256, sigma.verify_percentage_with_cap),
        6: (264, 672, _verify_range(6)),
        7: (264, 736, _verify_range(7)),
        8: (264, 800, _verify_range(8)),
        9: (160, 160, sigma.verify_grouped_ciphertext_2_handles_validity),
        10: (256, 160,
             sigma.verify_batched_grouped_ciphertext_2_handles_validity),
        11: (224, 192, sigma.verify_grouped_ciphertext_3_handles_validity),
        12: (352, 192,
             sigma.verify_batched_grouped_ciphertext_3_handles_validity),
    }


def _verify_range(logn: int):
    def verify(context: bytes, proof: bytes) -> None:
        from .zksdk import rangeproof as rp
        from .zksdk.merlin import Transcript
        from .zksdk.sigma import ZkError

        comms_blob = context[: 8 * 32]
        bits_blob = context[8 * 32 : 8 * 32 + 8]
        # batch length = first all-zero commitment (Agave's rule)
        batch = 0
        while batch < 8 and comms_blob[32 * batch : 32 * (batch + 1)] != \
                bytes(32):
            batch += 1
        if batch == 0:
            raise ZkError("empty commitment batch")
        t = Transcript(b"batched-range-proof-instruction")
        t.append_message(b"commitments", comms_blob)
        t.append_message(b"bit-lengths", bits_blob)
        rp.verify_range_proof(
            [comms_blob[32 * i : 32 * (i + 1)] for i in range(batch)],
            list(bits_blob[:batch]),
            proof, t, logn,
        )

    return verify


def zk_elgamal_program(executor, ctx, program_id, iaccts, data, *,
                       pda_signers):
    from .programs import AcctError
    from .executor import InstrError
    from .zksdk.sigma import ZkError

    if not data:
        raise InstrError("zk: empty instruction")
    tag = data[0]
    # the protocol's fixed per-instruction CU charge (bulletproof range
    # verifies are the most expensive builtins — an unpriced verify
    # would bypass the block cost model entirely)
    ctx.charge(INSTR_COMPUTE_UNITS.get(tag, 6_000))
    if tag == 0:
        return _close_context_state(ctx, iaccts)
    table = _sizes()
    if tag not in table:
        raise InstrError(f"zk: unknown instruction {tag}")
    ctx_sz, proof_sz, verify = table[tag]

    accessed = 0
    if len(data) == 5:
        # proof data from account 0 at a u32 offset
        if not iaccts:
            raise AcctError("zk: missing proof-data account")
        off = int.from_bytes(data[1:5], "little")
        acct = ctx.accounts[iaccts[0].txn_idx]
        blob = bytes(acct.data)
        if off + ctx_sz + proof_sz > len(blob):
            raise InstrError("zk: proof data out of account bounds")
        context = blob[off : off + ctx_sz]
        proof = blob[off + ctx_sz : off + ctx_sz + proof_sz]
        accessed = 1
    else:
        if len(data) != 1 + ctx_sz + proof_sz:
            raise InstrError("zk: bad instruction data size")
        context = data[1 : 1 + ctx_sz]
        proof = data[1 + ctx_sz :]

    try:
        verify(context, proof)
    except ZkError as e:
        raise InstrError(f"zk: {e}")

    # optional context-state creation
    if len(iaccts) > accessed:
        if len(iaccts) < accessed + 2:
            raise AcctError("zk: context state needs authority account")
        authority = ctx.accounts[iaccts[accessed + 1].txn_idx].key
        state_ia = iaccts[accessed]
        state = ctx.accounts[state_ia.txn_idx]
        if state.owner != ZK_ELGAMAL_PROOF_PROGRAM:
            raise AcctError("zk: context account not program-owned")
        if len(state.data) >= CTX_HEAD_SZ and state.data[32] != 0:
            raise InstrError("zk: context account already initialized")
        if len(state.data) != CTX_HEAD_SZ + ctx_sz:
            raise InstrError("zk: context account wrong size")
        if not state_ia.is_writable:
            raise AcctError("zk: context account not writable")
        state.data = bytearray(authority + bytes([tag]) + context)


def _close_context_state(ctx, iaccts):
    from .programs import AcctError
    from .executor import InstrError
    from ..protocol.txn import SYSTEM_PROGRAM

    if len(iaccts) < 3:
        raise AcctError("zk close: needs proof, dest, owner accounts")
    proof_ia, dest_ia, owner_ia = iaccts[0], iaccts[1], iaccts[2]
    if not owner_ia.is_signer:
        raise AcctError("zk close: owner must sign")
    proof_acct = ctx.accounts[proof_ia.txn_idx]
    dest_acct = ctx.accounts[dest_ia.txn_idx]
    owner = ctx.accounts[owner_ia.txn_idx].key
    if proof_acct.owner != ZK_ELGAMAL_PROOF_PROGRAM:
        # only THIS program's accounts may be drained/reassigned here —
        # native programs mutate accounts directly, so the BPF-side
        # owner-may-debit backstop never runs for them
        raise AcctError("zk close: account not owned by the zk program")
    if proof_acct.key == dest_acct.key:
        raise InstrError("zk close: dest == proof account")
    if len(proof_acct.data) < CTX_HEAD_SZ:
        raise InstrError("zk close: not a context account")
    if bytes(proof_acct.data[:32]) != owner:
        raise AcctError("zk close: wrong context authority")
    if not proof_ia.is_writable or not dest_ia.is_writable:
        raise AcctError("zk close: accounts not writable")
    dest_acct.lamports += proof_acct.lamports
    proof_acct.lamports = 0
    proof_acct.data = bytearray()
    proof_acct.owner = SYSTEM_PROGRAM
