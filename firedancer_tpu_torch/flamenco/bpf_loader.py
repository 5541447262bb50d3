"""Upgradeable BPF loader: deploy, upgrade and close programs through txns
(the port's copy of firedancer_tpu/flamenco/bpf_loader.py): instruction
processing, the account state machine, and the programdata indirection
the executor resolves at invoke time.

Account states (bincode u32 discriminant):

    0 Uninitialized
    1 Buffer      { authority: Option<Pubkey> }            data from 37
    2 Program     { programdata_address: Pubkey }          (36 bytes)
    3 ProgramData { slot u64, upgrade_authority: Option }  ELF from 45

Instructions (bincode u32 tag):

    0 InitializeBuffer                     [buffer w, authority]
    1 Write { offset u32, bytes Vec<u8> }  [buffer w, authority s]
    2 DeployWithMaxDataLen { max u64 }     [payer s w, programdata w,
                                            program w, buffer w,
                                            authority s]
    3 Upgrade                              [programdata w, program w,
                                            buffer w, spill w,
                                            authority s]
    4 SetAuthority                         [target w, cur auth s,
                                            (new authority)]
    5 Close                                [target w, recipient w,
                                            authority s, (program w)]

Deploy-slot visibility: a program (re)deployed in slot N is invokable
from slot N+1 (ProgramData.slot records the deploy; the executor rejects
same-slot invocation) — LoaderV3's delay rule.
"""

from __future__ import annotations

from .programs import AcctError, _u32, _u64
from ..protocol import pda, sbpf
from ..protocol.base58 import b58_decode32
from ..protocol.txn import SYSTEM_PROGRAM

UPGRADEABLE_LOADER_PROGRAM = b58_decode32(
    "BPFLoaderUpgradeab1e11111111111111111111111"
)

ST_UNINITIALIZED = 0
ST_BUFFER = 1
ST_PROGRAM = 2
ST_PROGRAMDATA = 3

BUFFER_META_SIZE = 4 + 1 + 32          # disc | authority option
PROGRAM_SIZE = 4 + 32                  # disc | programdata address
PROGRAMDATA_META_SIZE = 4 + 8 + 1 + 32  # disc | slot | authority option


def _opt_key(some: bool, key: bytes) -> bytes:
    return bytes([1]) + key if some else bytes([0]) + bytes(32)


def buffer_encode(authority: bytes | None, payload: bytes = b"") -> bytes:
    return (
        ST_BUFFER.to_bytes(4, "little")
        + _opt_key(authority is not None, authority or bytes(32))
        + payload
    )


def program_encode(programdata: bytes) -> bytes:
    return ST_PROGRAM.to_bytes(4, "little") + programdata


def programdata_encode(slot: int, authority: bytes | None,
                       elf: bytes = b"") -> bytes:
    return (
        ST_PROGRAMDATA.to_bytes(4, "little")
        + slot.to_bytes(8, "little")
        + _opt_key(authority is not None, authority or bytes(32))
        + elf
    )


def state_of(data: bytes) -> int:
    if len(data) < 4:
        return ST_UNINITIALIZED
    return _u32(data)


def buffer_authority(data: bytes) -> bytes | None:
    if len(data) < BUFFER_META_SIZE or state_of(data) != ST_BUFFER:
        raise AcctError("not a buffer account")
    return bytes(data[5:37]) if data[4] else None


def program_programdata(data: bytes) -> bytes:
    if len(data) < PROGRAM_SIZE or state_of(data) != ST_PROGRAM:
        raise AcctError("not a program account")
    return bytes(data[4:36])


def programdata_meta(data: bytes) -> tuple[int, bytes | None]:
    """-> (deploy_slot, upgrade_authority)."""
    if len(data) < PROGRAMDATA_META_SIZE or state_of(data) != ST_PROGRAMDATA:
        raise AcctError("not a programdata account")
    auth = bytes(data[13:45]) if data[12] else None
    return _u64(data[4:]), auth


def programdata_elf(data: bytes) -> bytes:
    if len(data) < PROGRAMDATA_META_SIZE or state_of(data) != ST_PROGRAMDATA:
        raise AcctError("not a programdata account")
    return bytes(data[PROGRAMDATA_META_SIZE:])


def _clock_slot(ctx) -> int:
    from . import types as T

    blob = ctx.sysvars.get("clock")
    if not blob:
        raise AcctError("loader instruction requires the clock sysvar")
    clock, _ = T.CLOCK.decode(blob, 0)
    return clock.slot


def upgradeable_loader_program(executor, ctx, program_id, iaccts, data,
                               *, pda_signers):
    if len(data) < 4:
        raise AcctError("malformed loader instruction")
    tag = _u32(data)

    def acct(i, *, owned: bool = True):
        if i >= len(iaccts):
            raise AcctError(f"loader instr needs account {i}")
        a = ctx.accounts[iaccts[i].txn_idx]
        if owned and a.owner != UPGRADEABLE_LOADER_PROGRAM:
            raise AcctError(f"account {i} not owned by the loader")
        return a

    def need_writable(i):
        if i >= len(iaccts):
            raise AcctError(f"loader instr needs account {i}")
        if not iaccts[i].is_writable:
            raise AcctError(f"loader account {i} not writable")

    def need_signer(i):
        if i >= len(iaccts):
            raise AcctError(f"loader instr needs account {i}")
        ia = iaccts[i]
        if not (ia.is_signer or ctx.accounts[ia.txn_idx].key in pda_signers):
            raise AcctError(f"loader account {i} must sign")

    if tag == 0:  # InitializeBuffer; [buffer w, authority]
        buf = acct(0)
        need_writable(0)
        if state_of(bytes(buf.data)) != ST_UNINITIALIZED:
            raise AcctError("buffer already initialized")
        if len(buf.data) < BUFFER_META_SIZE:
            raise AcctError("buffer account too small")
        authority = acct(1, owned=False).key if len(iaccts) > 1 else None
        meta = buffer_encode(authority)
        buf.data[: len(meta)] = meta
    elif tag == 1:  # Write { offset u32, bytes Vec<u8> }; [buffer w, auth s]
        if len(data) < 4 + 4 + 8:
            raise AcctError("malformed loader write")
        offset = _u32(data[4:])
        n = _u64(data[8:])
        if len(data) < 16 + n:
            raise AcctError("short loader write payload")
        payload = data[16 : 16 + n]
        buf = acct(0)
        need_writable(0)
        auth = buffer_authority(bytes(buf.data))
        if auth is None:
            raise AcctError("buffer is immutable")
        need_signer(1)
        if acct(1, owned=False).key != auth:
            raise AcctError("wrong buffer authority")
        end = BUFFER_META_SIZE + offset + n
        if end > len(buf.data):
            raise AcctError("write past end of buffer account")
        buf.data[BUFFER_META_SIZE + offset : end] = payload
    elif tag == 2:  # DeployWithMaxDataLen { max_data_len u64 }
        # [payer s w, programdata w, program w, buffer w, authority s]
        if len(data) < 12:
            raise AcctError("malformed deploy")
        max_len = _u64(data[4:])
        need_signer(0)
        need_writable(0)
        progdata, program, buf = acct(1, owned=False), acct(2), acct(3)
        need_writable(1)
        need_writable(2)
        need_writable(3)
        need_signer(4)
        authority = acct(4, owned=False)
        if state_of(bytes(program.data)) != ST_UNINITIALIZED:
            raise AcctError("program account already deployed")
        if len(program.data) < PROGRAM_SIZE:
            raise AcctError("program account too small")
        buf_auth = buffer_authority(bytes(buf.data))
        if buf_auth is None or buf_auth != authority.key:
            raise AcctError("deploy authority does not match buffer")
        elf = bytes(buf.data[BUFFER_META_SIZE:])
        if max_len < len(elf):
            raise AcctError("max_data_len smaller than buffer contents")
        expect, _bump = pda.find_program_address(
            [program.key], UPGRADEABLE_LOADER_PROGRAM
        )
        if expect != progdata.key:
            raise AcctError("programdata address derivation mismatch")
        if progdata.owner not in (SYSTEM_PROGRAM, UPGRADEABLE_LOADER_PROGRAM):
            raise AcctError("programdata account has a foreign owner")
        if state_of(bytes(progdata.data)) not in (ST_UNINITIALIZED,):
            raise AcctError("programdata already in use")
        _validate_elf(elf)
        slot = _clock_slot(ctx)
        progdata.owner = UPGRADEABLE_LOADER_PROGRAM
        progdata.data = bytearray(
            programdata_encode(slot, authority.key, elf)
            + bytes(max_len - len(elf))
        )
        program.data = bytearray(program_encode(progdata.key))
        program.executable = True
        # buffer is consumed: lamports to the payer, account cleared
        ctx.accounts[iaccts[0].txn_idx].lamports += buf.lamports
        buf.lamports = 0
        buf.data = bytearray()
        buf.owner = SYSTEM_PROGRAM
    elif tag == 3:  # Upgrade; [programdata w, program w, buffer w, spill w,
        #            authority s]
        progdata, program, buf = acct(0), acct(1), acct(2)
        need_writable(0)
        need_writable(1)
        need_writable(2)
        need_writable(3)
        spill = acct(3, owned=False)
        need_signer(4)
        authority = acct(4, owned=False)
        pd_addr = program_programdata(bytes(program.data))
        if pd_addr != progdata.key:
            raise AcctError("program does not reference this programdata")
        _slot0, upgrade_auth = programdata_meta(bytes(progdata.data))
        if upgrade_auth is None:
            raise AcctError("program is not upgradeable")
        if upgrade_auth != authority.key:
            raise AcctError("wrong upgrade authority")
        buf_auth = buffer_authority(bytes(buf.data))
        if buf_auth is None or buf_auth != authority.key:
            raise AcctError("upgrade authority does not match buffer")
        elf = bytes(buf.data[BUFFER_META_SIZE:])
        cap = len(progdata.data) - PROGRAMDATA_META_SIZE
        if len(elf) > cap:
            raise AcctError("upgrade larger than programdata capacity")
        _validate_elf(elf)
        slot = _clock_slot(ctx)
        progdata.data = bytearray(
            programdata_encode(slot, authority.key, elf)
            + bytes(cap - len(elf))
        )
        spill.lamports += buf.lamports
        buf.lamports = 0
        buf.data = bytearray()
        buf.owner = SYSTEM_PROGRAM
    elif tag == 4:  # SetAuthority; [target w, cur authority s, (new)]
        target = acct(0)
        need_writable(0)
        need_signer(1)
        cur = acct(1, owned=False)
        new_auth = acct(2, owned=False).key if len(iaccts) > 2 else None
        st = state_of(bytes(target.data))
        if st == ST_BUFFER:
            auth = buffer_authority(bytes(target.data))
            if auth is None:
                raise AcctError("buffer is immutable")
            if auth != cur.key:
                raise AcctError("wrong buffer authority")
            if new_auth is None:
                raise AcctError("buffers cannot drop their authority")
            payload = bytes(target.data[BUFFER_META_SIZE:])
            target.data = bytearray(buffer_encode(new_auth, payload))
        elif st == ST_PROGRAMDATA:
            slot0, auth = programdata_meta(bytes(target.data))
            if auth is None:
                raise AcctError("program is final (no authority)")
            if auth != cur.key:
                raise AcctError("wrong upgrade authority")
            elf = bytes(target.data[PROGRAMDATA_META_SIZE:])
            target.data = bytearray(programdata_encode(slot0, new_auth, elf))
        else:
            raise AcctError("set-authority target is neither buffer nor "
                            "programdata")
    elif tag == 5:  # Close; [target w, recipient w, authority s, (program w)]
        target = acct(0)
        need_writable(0)
        need_writable(1)
        recipient = acct(1, owned=False)
        st = state_of(bytes(target.data))
        if target.key == recipient.key:
            raise AcctError("cannot close an account into itself")
        if st == ST_UNINITIALIZED:
            pass  # uninitialized closes freely
        elif st == ST_BUFFER:
            auth = buffer_authority(bytes(target.data))
            need_signer(2)
            if auth is None or acct(2, owned=False).key != auth:
                raise AcctError("wrong buffer authority")
        elif st == ST_PROGRAMDATA:
            _slot0, auth = programdata_meta(bytes(target.data))
            need_signer(2)
            if auth is None or acct(2, owned=False).key != auth:
                raise AcctError("wrong upgrade authority")
            program = acct(3)
            need_writable(3)
            if program_programdata(bytes(program.data)) != target.key:
                raise AcctError("program does not reference this programdata")
            # the program account is dead from the next slot on: the
            # executor fails invocations whose programdata is closed
            program.executable = False
        else:
            raise AcctError("close target must be buffer or programdata")
        recipient.lamports += target.lamports
        target.lamports = 0
        target.data = bytearray()
        target.owner = SYSTEM_PROGRAM
    else:
        raise AcctError(f"unknown loader instruction {tag}")


def _validate_elf(elf: bytes) -> None:
    try:
        sbpf.load(elf)
    except sbpf.SbpfError as e:
        raise AcctError(f"deploy of invalid ELF: {e}") from e
