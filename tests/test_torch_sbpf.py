"""The port's sBPF loader and decoder (protocol/sbpf.py) against the JAX
package's, exactly: tests/test_sbpf.py's six cases on both (the loaded
Program, field by field, or the SbpfError's message), the port's ELF
writer (models/workload.build_elf) byte for byte against the test suite's,
the decoder over seeded random texts, and a loader fuzz in the manner of
tests/test_fuzz.py's: seeded mutations of valid ELFs (bytes flipped,
truncated, header fields and section entries overwritten, relocation
tables and entry points moved) must be accepted or refused alike, with
the same Program or the same message."""

import struct
import tracemalloc
from dataclasses import asdict

import numpy as np
import pytest

from firedancer_tpu.protocol import sbpf as jsbpf
from firedancer_tpu_torch.models import workload as tw
from firedancer_tpu_torch.protocol import sbpf as tsbpf
from tests.test_sbpf import build_elf as jax_build_elf
from tests.test_sbpf import ins as jax_ins

ins, build_elf = tw.ins, tw.build_elf
EXIT = ins(0x95)
MOV = ins(0xB7, dst=0, imm=42)


def load_both(elf: bytes):
    """(kind, value) of each package's load: the Program's fields or the
    error's message; the two must agree."""
    out = []
    for S in (jsbpf, tsbpf):
        try:
            p = S.load(elf)
            out.append(("ok", bytes(p.rodata), p.text_off, p.text_sz, p.entry_pc,
                        [asdict(s) for s in p.sections]))
        except S.SbpfError as e:
            out.append(("err", str(e)))
    assert out[1] == out[0]
    return out[1]


def decode_both(text: bytes):
    out = []
    for S in (jsbpf, tsbpf):
        try:
            out.append(("ok", [(i.pc, i.opcode, i.dst, i.src, i.off, i.imm, i.mnemonic)
                               for i in S.decode(text)]))
        except S.SbpfError as e:
            out.append(("err", str(e)))
    assert out[1] == out[0]
    return out[1]


def test_writer_and_ins_equal_the_test_suites():
    rng = np.random.default_rng(7)
    for _ in range(64):
        op, dst, src = (int(v) for v in rng.integers(0, 256, 3) % (256, 11, 11))
        off, imm = int(rng.integers(-2**15, 2**15)), int(rng.integers(-2**31, 2**31))
        assert ins(op, dst, src, off, imm) == jax_ins(op, dst, src, off, imm)
    text = MOV + ins(0x18, dst=1, imm=0x1000) + bytes(8) + EXIT
    for kw in ({}, {"rodata": b"hello"}, {"rels": ((64, 8),), "rodata": b"xy"},
               {"machine": 263, "entry_slot": 1, "text_addr": 0x200}):
        assert build_elf(text, **kw) == jax_build_elf(text, **kw)
    assert tw.lddw(3, 0x1122334455667788) == (jax_ins(0x18, dst=3, imm=0x55667788) + bytes(4)
                                              + (0x11223344).to_bytes(4, "little"))


def test_load_minimal_program():
    got = load_both(build_elf(MOV + EXIT))
    assert got[0] == "ok" and got[4] == 0
    prog = tsbpf.load(build_elf(MOV + EXIT))
    assert prog.text() == MOV + EXIT
    assert [i.mnemonic for i in tsbpf.decode(prog.text())] == ["mov64_imm", "exit"]


@pytest.mark.parametrize("case,match", [
    ("zeros", "magic"), ("x86", "machine"), ("entry", "entrypoint"), ("ragged", "slot")])
def test_load_rejects_bad_inputs(case, match):
    elf = {"zeros": b"\x00" * 200, "x86": build_elf(EXIT, machine=62),
           "entry": build_elf(EXIT, entry_slot=5), "ragged": build_elf(EXIT + b"\x01")}[case]
    got = load_both(elf)
    assert got[0] == "err" and match in got[1]


def test_relative_relocation_rebases():
    text = ins(0x18, dst=1, imm=0x1000) + bytes(8) + EXIT
    elf = build_elf(text, rodata=b"hello-program-data", rels=((64, tsbpf.R_BPF_64_RELATIVE),))
    assert load_both(elf)[0] == "ok"
    insns = tsbpf.decode(tsbpf.load(elf).text())
    assert insns[0].imm == 0x1000 + tsbpf.MM_PROGRAM_START


def test_relocation_out_of_bounds_rejected():
    text = ins(0x18, dst=1, imm=0) + bytes(8) + EXIT
    got = load_both(build_elf(text, rels=((64 + len(text) - 8, tsbpf.R_BPF_64_RELATIVE),)))
    assert got[0] == "err" and "out of bounds" in got[1]


def test_decode_rejects_bad_registers():
    got = decode_both(bytes([0xB7, 12]) + bytes(6))
    assert got[0] == "err" and "bad register" in got[1]


def test_decode_lddw_and_jumps():
    text = (ins(0x18, dst=2, imm=0xDEAD) + bytes(4) + (0xBEEF).to_bytes(4, "little")
            + ins(0x15, dst=2, off=-2, imm=7) + EXIT)
    got = decode_both(text)[1]
    assert got[0][5] == (0xBEEF << 32) | 0xDEAD and got[1][0] == 2 and got[1][4] == -2
    assert "unknown opcode" in decode_both(ins(0xFF))[1]
    assert "lddw at end" in decode_both(ins(0x18))[1]


@pytest.mark.parametrize("seed", range(40))
def test_decode_random_text_matches_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    ops = sorted(tsbpf.MNEMONICS)
    slots = []
    for _ in range(int(rng.integers(1, 40))):
        op = int(rng.choice(ops)) if rng.random() < 0.95 else int(rng.integers(0, 256))
        reg = int(rng.integers(0, 12)) if rng.random() < 0.05 else int(rng.integers(0, 11))
        slots.append(ins(op, reg, int(rng.integers(0, 11)), int(rng.integers(-2**15, 2**15)),
                         int(rng.integers(-2**31, 2**31))))
    decode_both(b"".join(slots))


# -- the loader fuzz ---------------------------------------------------------------------------

_SHDR = struct.Struct("<IIQQQQIIQQ")


def _seeds() -> list[bytes]:
    text = ins(0x18, dst=1, imm=0x1000) + bytes(8) + MOV + EXIT
    return [build_elf(MOV + EXIT),
            build_elf(text, rodata=b"hello-program-data", rels=((64, 8),)),
            build_elf(text, rodata=b"ro", rels=((64, 1),), machine=263),
            tw.sbpf_programs()["vault"][1]]


def mutate(elf: bytes, rng) -> bytes:
    b = bytearray(elf)
    kind = int(rng.integers(0, 7))
    if kind == 0:  # flip random bytes
        for _ in range(int(rng.integers(1, 9))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
    elif kind == 1:  # truncate
        b = b[: int(rng.integers(0, len(b)))]
    elif kind == 2:  # an ELF header field
        off = int(rng.choice([4, 5, 18, 24, 40, 58, 60, 62]))
        width = 8 if off in (24, 40) else (1 if off in (4, 5) else 2)
        b[off : off + width] = int(rng.integers(0, 2**min(8 * width, 16))).to_bytes(width,
                                                                                    "little")
    elif kind == 3:  # a section header field
        shoff = int.from_bytes(b[40:48], "little")
        shnum = int.from_bytes(b[60:62], "little")
        i = int(rng.integers(0, max(1, shnum)))
        field_off = int(rng.choice([0, 4, 8, 16, 24, 32]))
        width = 4 if field_off < 8 else 8
        at = shoff + i * _SHDR.size + field_off
        # at most 64 KiB: the JAX loader allocates an image as large as a
        # section claims before it checks the section's bounds
        val = int(rng.choice([0, 1, 2, 3, 6, 8, 9, 64, 0x100, len(b), 0x10000]))
        b[at : at + width] = (val % 2**(8 * width)).to_bytes(width, "little")
    elif kind == 4:  # a relocation entry pointing anywhere, of any kind
        b += struct.pack("<QQ", int(rng.integers(0, len(b) + 32)), int(rng.integers(0, 16)))
    elif kind == 5:  # the entry point moved
        b[24:32] = int(rng.integers(0, 0x400)).to_bytes(8, "little")
    else:  # random bytes appended or inserted
        at = int(rng.integers(0, len(b)))
        b[at:at] = rng.bytes(int(rng.integers(1, 32)))
    return bytes(b)


def claimed_image(elf: bytes) -> int:
    """The image size the loaders would build from the alloc sections'
    offsets and sizes (0 when the section table is unreadable)."""
    if len(elf) < 64:
        return 0
    shoff, shentsize, shnum = (int.from_bytes(elf[40:48], "little"),
                               int.from_bytes(elf[58:60], "little"),
                               int.from_bytes(elf[60:62], "little"))
    if shentsize != _SHDR.size or shoff + shnum * _SHDR.size > len(elf):
        return 0
    shdrs = [_SHDR.unpack_from(elf, shoff + i * _SHDR.size) for i in range(shnum)]
    return max([sh[4] + sh[5] for sh in shdrs if sh[2] & 0x2], default=0)


# the largest image the JAX side of a test is run on: the JAX loader
# allocates the whole claimed image before its checks
JAX_IMAGE_CAP = 16 * 1024 * 1024


@pytest.mark.parametrize("seed", range(200))
def test_loader_fuzz_matches_jax(seed):
    """Where a mutation makes a section claim more than JAX_IMAGE_CAP, the
    JAX loader would allocate that much before its checks (a MemoryError
    at best): there the port alone runs, and it must give a verdict without
    building the claimed image (its file bytes stay within the ELF's)."""
    rng = np.random.default_rng(seed)
    elf = _seeds()[seed % 4]
    for _ in range(1 + seed % 3):
        elf = mutate(elf, rng)
    if claimed_image(elf) > JAX_IMAGE_CAP:
        try:
            p = tsbpf.load(elf)
        except tsbpf.SbpfError:
            return
        assert len(p.rodata) == claimed_image(elf)
        assert len(p.rodata.dense) <= len(elf)
    else:
        load_both(elf)


def test_loader_fuzz_reaches_both_verdicts():
    verdicts = set()
    for seed in range(200):
        rng = np.random.default_rng(seed)
        elf = _seeds()[seed % 4]
        for _ in range(1 + seed % 3):
            elf = mutate(elf, rng)
        try:
            tsbpf.load(elf)
            verdicts.add("ok")
        except tsbpf.SbpfError as e:
            verdicts.add(str(e).split(" ")[0])
    assert "ok" in verdicts and len(verdicts) >= 6, verdicts


def claim_rodata(text: bytes, sh_type: int, size: int, rels=()) -> bytes:
    """build_elf's ELF over `text` (and `rels`) with its .rodata section
    header rewritten to `sh_type` and `size` bytes (sh_type 8, SHT_NOBITS,
    makes it a .bss that carries no bytes in the file)."""
    elf = bytearray(build_elf(text, rodata=b"ro", rels=rels))
    shoff = int.from_bytes(elf[40:48], "little")
    at = shoff + 2 * _SHDR.size  # the .rodata section header
    elf[at + 4 : at + 8] = sh_type.to_bytes(4, "little")
    elf[at + 32 : at + 40] = size.to_bytes(8, "little")
    return bytes(elf)


@pytest.mark.parametrize("sh_type", [1, 8])
def test_huge_section_refused_before_any_allocation(sh_type):
    """A section claiming 2 GiB, where the JAX loader would allocate it
    first, so the JAX side is not run here.  With file bytes (PROGBITS) the
    port refuses it out of bounds before building the image; as a .bss
    (NOBITS) it loads, as JAX's verdict is, with a traced peak of a few MiB:
    the zero tail is never allocated, and reads of it see zeros."""
    elf = claim_rodata(MOV + EXIT, sh_type, 2**31)
    if sh_type == 1:
        with pytest.raises(tsbpf.SbpfError, match="out of bounds"):
            tsbpf.load(elf)
        return
    tracemalloc.start()
    try:
        p = tsbpf.load(elf)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 * 1024 * 1024, peak
    ro = next(s for s in p.sections if s.name == ".rodata")
    assert len(p.rodata) == ro.offset + 2**31
    assert p.rodata[2**31 : 2**31 + 8] == bytes(8)
    assert p.rodata[len(p.rodata) - 4 : len(p.rodata) + 4] == bytes(4)
    assert (p.text_sz, p.entry_pc) == (len(MOV + EXIT), 0)


def test_bss_past_max_image_refused_where_jax_loads_it():
    """Kept under its first name: the .bss verdict the two loaders once did
    not share.  A .bss of 11 MiB stretches the image past 10 MiB; the JAX
    loader builds the 11 MiB image and accepts the ELF, and so does the
    port now, with the same image (its zero tail read, not allocated) and
    the same Program fields.  A small .bss loads alike too, and so do
    relocations that land in the tail (kept as patches over its zeros) or
    straddle the edge between the file's bytes and the tail."""
    size = 11 * 1024 * 1024
    elf = claim_rodata(MOV + EXIT, 8, size)
    out = load_both(elf)
    ro_off = next(s["offset"] for s in out[5] if s["name"] == ".rodata")
    assert out[0] == "ok" and len(out[1]) == ro_off + size
    p = tsbpf.load(elf)
    assert len(p.rodata.dense) < len(elf)
    assert load_both(claim_rodata(MOV + EXIT, 8, 4096))[0] == "ok"
    for at in (0, 4000, -8, -4):  # from the first byte of the tail
        rel = ((ro_off + at, tsbpf.R_BPF_64_RELATIVE),)
        out = load_both(claim_rodata(MOV + EXIT, 8, 4096, rels=rel))
        assert out[0] == "ok" and any(out[1][ro_off:])
