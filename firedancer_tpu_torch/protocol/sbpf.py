"""sBPF ELF loader + instruction decoder (the port's copy of
firedancer_tpu/protocol/sbpf.py).

Parse and validate a Solana BPF program ELF (little-endian ELF64,
e_machine BPF/SBPF), locate .text / read-only sections and the
entrypoint, and apply the two load-time relocation kinds the protocol
uses (R_BPF_64_64 symbol addresses, R_BPF_64_RELATIVE rebasing into the
program's VM address space at MM_PROGRAM_START = 2^32).  The instruction
decoder covers the sBPF ISA encoding (8-byte slots: opcode, dst/src
registers, 16-bit offset, 32-bit immediate; lddw spans two slots) — the
VM interpreter builds on it.

ELF structure constants (magic, header offsets, section-header layout,
relocation encodings) are the public ELF-64 / Solana sBPF ABI.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

EM_BPF = 247
EM_SBPF = 263
MM_PROGRAM_START = 1 << 32

R_BPF_64_64 = 1
R_BPF_64_RELATIVE = 8
SHT_NOBITS = 8

_EHDR = struct.Struct("<16sHHIQQQIHHHHHH")
_SHDR = struct.Struct("<IIQQQQIIQQ")
_REL = struct.Struct("<QQ")  # r_offset, r_info
_SYM = struct.Struct("<IBBHQQ")


class SbpfError(ValueError):
    pass


@dataclass
class Section:
    name: str
    sh_type: int
    flags: int
    addr: int
    offset: int
    size: int


class Image:
    """A read-only program image of `size` bytes: `dense` holds its bytes
    up to the end of the last section with file bytes, and past that the
    image reads zeros (the .bss tail), except where a relocation wrote into
    the tail (`patches`, byte offset -> byte).  The tail is never
    allocated, so its size is bounded by nothing but the ELF's claim, while
    the patches are bounded by the relocation table's size.  `len`,
    `bytes` and slices read it as the dense bytearray it stands for."""

    __slots__ = ("dense", "size", "patches")

    def __init__(self, dense: bytearray, size: int):
        self.dense = dense
        self.size = size
        self.patches: dict[int, int] = {}

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, key: slice) -> bytes:
        start, stop, _ = key.indices(self.size)
        stop = max(start, stop)
        out = bytearray(self.dense[start:stop])
        if stop > len(self.dense):
            lo = max(start, len(self.dense))
            out += bytes(stop - lo)
            for off, b in self.patches.items():
                if lo <= off < stop:
                    out[off - start] = b
        return bytes(out)

    def __bytes__(self) -> bytes:
        return self[:]

    def write(self, off: int, data: bytes) -> None:
        """Write `data` at `off`, in bounds (the loader checks)."""
        n = len(self.dense)
        if off < n:
            self.dense[off : min(n, off + len(data))] = data[: n - off]
        for i in range(max(off, n), off + len(data)):
            self.patches[i] = data[i - off]


@dataclass
class Program:
    rodata: Image          # the loaded program image (text + ro sections)
    text_off: int          # byte offset of .text within rodata
    text_sz: int
    entry_pc: int          # entrypoint as an instruction index into text
    sections: list[Section]

    def text(self) -> bytes:
        return bytes(self.rodata[self.text_off : self.text_off + self.text_sz])


def load(elf: bytes) -> Program:
    """Parse + validate + relocate (fd_sbpf_program_load)."""
    if len(elf) < _EHDR.size:
        raise SbpfError("truncated ELF header")
    (
        ident, e_type, e_machine, e_version, e_entry, _phoff, e_shoff,
        _flags, _ehsize, _phentsz, _phnum, e_shentsize, e_shnum, e_shstrndx,
    ) = _EHDR.unpack_from(elf, 0)
    if ident[:4] != b"\x7fELF":
        raise SbpfError("bad ELF magic")
    if ident[4] != 2 or ident[5] != 1:
        raise SbpfError("sBPF requires little-endian ELF64")
    if e_machine not in (EM_BPF, EM_SBPF):
        raise SbpfError(f"not a BPF machine type ({e_machine})")
    if e_shentsize != _SHDR.size or e_shoff + e_shnum * _SHDR.size > len(elf):
        raise SbpfError("malformed section table")

    raw_shdrs = [
        _SHDR.unpack_from(elf, e_shoff + i * _SHDR.size) for i in range(e_shnum)
    ]
    if e_shstrndx >= e_shnum:
        raise SbpfError("bad shstrndx")
    str_off, str_sz = raw_shdrs[e_shstrndx][4], raw_shdrs[e_shstrndx][5]

    def name_at(off: int) -> str:
        end = elf.find(b"\x00", str_off + off, str_off + str_sz)
        if end < 0:
            raise SbpfError("unterminated section name")
        return elf[str_off + off : end].decode(errors="replace")

    sections = []
    for sh in raw_shdrs:
        sh_name, sh_type, sh_flags, sh_addr, sh_offset, sh_size = sh[:6]
        sections.append(
            Section(name_at(sh_name), sh_type, sh_flags, sh_addr, sh_offset, sh_size)
        )

    text = next((s for s in sections if s.name == ".text"), None)
    if text is None or text.size == 0:
        raise SbpfError("missing .text")
    if not text.flags & 0x2:
        raise SbpfError(".text must be an ALLOC section")
    if text.offset + text.size > len(elf):
        raise SbpfError(".text out of bounds")
    if text.size % 8:
        raise SbpfError(".text not a whole number of instruction slots")

    # program image: every alloc section copied at its file offset (the
    # reference builds a contiguous rodata image indexed by file offset).
    # EVERY copy is bounds-checked: a slice assignment fed fewer bytes
    # than its target SHRINKS a bytearray silently, corrupting the image.
    alloc = [s for s in sections if s.flags & 0x2]
    if not alloc:
        raise SbpfError("no loadable sections")
    # the bounds are checked, in section order, BEFORE the image is
    # built: the JAX loader allocates the whole image first, so a section
    # claiming gigabytes costs it that much memory (or a MemoryError)
    # before the same SbpfError.  A .bss (SHT_NOBITS) carries no bytes and
    # may claim any size: the image holds the file's bytes only, up to
    # the end of the last section that has them, and reads zeros past it
    for s in alloc:
        if s.sh_type != SHT_NOBITS and s.offset + s.size > len(elf):
            raise SbpfError(f"section '{s.name}' out of bounds")
    image_sz = max(s.offset + s.size for s in alloc)
    dense_sz = max((s.offset + s.size for s in alloc if s.sh_type != SHT_NOBITS), default=0)
    rodata = Image(bytearray(dense_sz), image_sz)
    for s in alloc:
        if s.sh_type == SHT_NOBITS:
            continue
        rodata.dense[s.offset : s.offset + s.size] = elf[s.offset : s.offset + s.size]

    # entrypoint: e_entry is a VM address inside .text
    if not (text.addr <= e_entry < text.addr + text.size):
        raise SbpfError("entrypoint outside .text")
    if (e_entry - text.addr) % 8:
        raise SbpfError("entrypoint not slot aligned")
    entry_pc = (e_entry - text.addr) // 8

    # relocations (.rel.dyn): the two protocol kinds
    rel = next((s for s in sections if s.name in (".rel.dyn", ".rel.text")), None)
    symtab = next((s for s in sections if s.name in (".dynsym", ".symtab")), None)
    if rel is not None:
        if rel.offset + rel.size > len(elf):
            raise SbpfError("relocation table out of bounds")
        for off in range(rel.offset, rel.offset + rel.size - _REL.size + 1, _REL.size):
            r_offset, r_info = _REL.unpack_from(elf, off)
            r_type = r_info & 0xFFFFFFFF
            r_sym = r_info >> 32
            if r_type not in (R_BPF_64_RELATIVE, R_BPF_64_64):
                continue  # other kinds: skipped (reference rejects few)
            # both kinds write an lddw imm pair: low 32 bits at +4, high
            # 32 bits at +12 — the FULL range must be in bounds (a slice
            # assign past the end would silently GROW the bytearray)
            if r_offset + 16 > len(rodata):
                raise SbpfError("relocation out of bounds")
            if r_type == R_BPF_64_RELATIVE:
                lo = int.from_bytes(rodata[r_offset + 4 : r_offset + 8], "little")
                hi = int.from_bytes(rodata[r_offset + 12 : r_offset + 16], "little")
                addr = (lo | (hi << 32)) + MM_PROGRAM_START
            else:  # R_BPF_64_64: absolute symbol address
                if symtab is None:
                    raise SbpfError("symbol relocation without symtab")
                sym_off = symtab.offset + r_sym * _SYM.size
                if sym_off + _SYM.size > len(elf):
                    raise SbpfError("relocation symbol out of bounds")
                _n, _i, _o, _shn, st_value, _sz = _SYM.unpack_from(elf, sym_off)
                addr = st_value + MM_PROGRAM_START
            rodata.write(r_offset + 4, (addr & 0xFFFFFFFF).to_bytes(4, "little"))
            rodata.write(r_offset + 12, ((addr >> 32) & 0xFFFFFFFF).to_bytes(4, "little"))
            # other kinds: ignored (parity: the reference rejects few,
            # skips the rest)

    return Program(
        rodata=rodata,
        text_off=text.offset,
        text_sz=text.size,
        entry_pc=entry_pc,
        sections=sections,
    )


# -- instruction decode -------------------------------------------------------

OP_LDDW = 0x18

# opcode -> mnemonic for the common sBPF subset (public ISA encoding)
MNEMONICS = {
    0x07: "add64_imm", 0x0F: "add64_reg", 0x17: "sub64_imm", 0x1F: "sub64_reg",
    0x27: "mul64_imm", 0x2F: "mul64_reg", 0x37: "div64_imm", 0x3F: "div64_reg",
    0x47: "or64_imm", 0x4F: "or64_reg", 0x57: "and64_imm", 0x5F: "and64_reg",
    0x67: "lsh64_imm", 0x6F: "lsh64_reg", 0x77: "rsh64_imm", 0x7F: "rsh64_reg",
    0x87: "neg64", 0x97: "mod64_imm", 0x9F: "mod64_reg",
    0xA7: "xor64_imm", 0xAF: "xor64_reg", 0xB7: "mov64_imm", 0xBF: "mov64_reg",
    0x18: "lddw",
    0x61: "ldxw", 0x69: "ldxh", 0x71: "ldxb", 0x79: "ldxdw",
    0x62: "stw", 0x6A: "sth", 0x72: "stb", 0x7A: "stdw",
    0x63: "stxw", 0x6B: "stxh", 0x73: "stxb", 0x7B: "stxdw",
    0x05: "ja", 0x15: "jeq_imm", 0x1D: "jeq_reg", 0x25: "jgt_imm",
    0x2D: "jgt_reg", 0x35: "jge_imm", 0x3D: "jge_reg", 0xA5: "jlt_imm",
    0xAD: "jlt_reg", 0xB5: "jle_imm", 0xBD: "jle_reg", 0x45: "jset_imm",
    0x4D: "jset_reg", 0x55: "jne_imm", 0x5D: "jne_reg", 0x65: "jsgt_imm",
    0x6D: "jsgt_reg", 0x75: "jsge_imm", 0x7D: "jsge_reg", 0xC5: "jslt_imm",
    0xCD: "jslt_reg", 0xD5: "jsle_imm", 0xDD: "jsle_reg",
    0x85: "call", 0x8D: "callx", 0x95: "exit",
    # 32-bit ALU class
    0x04: "add32_imm", 0x0C: "add32_reg", 0x14: "sub32_imm", 0x1C: "sub32_reg",
    0x24: "mul32_imm", 0x2C: "mul32_reg", 0x34: "div32_imm", 0x3C: "div32_reg",
    0x44: "or32_imm", 0x4C: "or32_reg", 0x54: "and32_imm", 0x5C: "and32_reg",
    0x64: "lsh32_imm", 0x6C: "lsh32_reg", 0x74: "rsh32_imm", 0x7C: "rsh32_reg",
    0x84: "neg32", 0x94: "mod32_imm", 0x9C: "mod32_reg",
    0xA4: "xor32_imm", 0xAC: "xor32_reg", 0xB4: "mov32_imm", 0xBC: "mov32_reg",
    0xC4: "arsh32_imm", 0xCC: "arsh32_reg", 0xC7: "arsh64_imm", 0xCF: "arsh64_reg",
    0xD4: "le", 0xDC: "be",
}


@dataclass(frozen=True)
class Insn:
    pc: int
    opcode: int
    dst: int
    src: int
    off: int
    imm: int
    mnemonic: str


def decode(text: bytes) -> list[Insn]:
    """Decode .text into instructions; lddw consumes two slots."""
    if len(text) % 8:
        raise SbpfError("text not slot aligned")
    out = []
    pc = 0
    n = len(text) // 8
    while pc < n:
        slot = text[pc * 8 : pc * 8 + 8]
        opcode = slot[0]
        dst = slot[1] & 0x0F
        src = slot[1] >> 4
        if dst > 10 or src > 10:  # r0..r10 only (the sBPF verifier rule)
            raise SbpfError(f"bad register (dst={dst}, src={src}) at pc {pc}")
        off = int.from_bytes(slot[2:4], "little", signed=True)
        imm = int.from_bytes(slot[4:8], "little", signed=True)
        if opcode == OP_LDDW:
            if pc + 1 >= n:
                raise SbpfError("lddw at end of text")
            hi = int.from_bytes(text[pc * 8 + 12 : pc * 8 + 16], "little")
            imm = (imm & 0xFFFFFFFF) | (hi << 32)
            out.append(Insn(pc, opcode, dst, src, off, imm, "lddw"))
            pc += 2
            continue
        mn = MNEMONICS.get(opcode)
        if mn is None:
            raise SbpfError(f"unknown opcode 0x{opcode:02x} at pc {pc}")
        out.append(Insn(pc, opcode, dst, src, off, imm, mn))
        pc += 1
    return out
