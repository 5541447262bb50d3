"""The loops of a built kernel, read from its SASS (cuobjdump -sass).

For each backward branch of one kernel: the instructions from its target
to the branch (with the instructions of any function it CALLs, to that
function's RET), counted by opcode, the longest chain of instructions
each reading a register the one before wrote, and the stall clocks ptxas
wrote into their control words, summed.  A vector load's or store's
registers count from its first; a loop's live-in registers start at depth
0.  The counts are what a warp running the loop issues an iteration, and
what its dependent instructions are: the latencies themselves are not in
the listing.

    python -m firedancer_tpu_torch.utils.sass [--forms] [--whole] LIB.so KERNEL [LIB.so ...]

prints each library's loops of KERNEL (cuobjdump from the CUDA toolkit
that kbuild uses); --forms counts each opcode with its modifiers
(IMAD.WIDE apart from IMAD.WIDE.U32); --whole counts the whole kernel as
one block instead, with the global loads a thread waits for in series
(`whole`), for a kernel without loops.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?(U?P[T0-9]+)\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_REG = re.compile(r"\b(U?R[0-9]+|U?P[0-6])\b")
_LABEL = re.compile(r"\s*(\.L_x_[0-9]+):")
_CTRL = re.compile(r"\s*/\* 0x([0-9a-f]{16}) \*/\s*$")
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BAR", "BRA", "EXIT", "RET", "NOP",
            "WARPSYNC", "BSYNC", "BSSY", "CALL", "MEMBAR", "DEPBAR", "YIELD")


def dump(so_path: str) -> str:
    """cuobjdump -sass of a library built by kbuild."""
    from . import kbuild

    cuobjdump = os.path.join(os.path.dirname(kbuild._nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                       timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {so_path} failed: {r.stderr.strip()}")
    return r.stdout


def _sections(listing: str) -> dict:
    """{function name: (instructions [(address, opcode, operands, stall,
    guard)], {label: index})} of a cuobjdump -sass listing.  stall is the
    clocks ptxas set the scheduler to wait after the instruction: bits
    41-44 of its control word, the second 64-bit word, on the next line;
    guard is the predicate register the instruction is guarded by, or
    None."""
    secs, cur = {}, None
    lines = listing.splitlines()
    for n, line in enumerate(lines):
        if "Function :" in line:
            cur = secs.setdefault(line.split("Function :", 1)[1].strip(), ([], {}))
            continue
        if cur is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            cur[1][lab.group(1)] = len(cur[0])
            continue
        m = _INSN.search(line)
        if m:
            ctrl = _CTRL.match(lines[n + 1]) if n + 1 < len(lines) else None
            stall = (int(ctrl.group(1), 16) >> 41) & 0xF if ctrl else 0
            cur[0].append((int(m.group(1), 16), m.group(3), m.group(4), stall, m.group(2)))
    return secs


def _target(args: str, labels: dict, addr_index: dict) -> int | None:
    """The instruction index a branch or call names, by label or address."""
    tgt = re.search(r"\(?(\.L_x_[0-9]+)\)?", args)
    if tgt and tgt.group(1) in labels:
        return labels[tgt.group(1)]
    num = re.search(r"0x([0-9a-f]+)", args)
    return addr_index.get(int(num.group(1), 16)) if num else None


def _callee(secs: dict, insns, labels, addr_index, args: str) -> list:
    """The instructions a CALL runs: from its target (a label or address of
    the same function, or another function by name) to the first RET."""
    start, body = _target(args, labels, addr_index), insns
    if start is None:
        name = re.search(r"`\(([^)]+)\)", args)
        if not name or name.group(1) not in secs:
            return []
        body, start = secs[name.group(1)][0], 0
    out = []
    for ins in body[start:]:
        out.append(ins)
        if ins[1].startswith("RET"):
            break
    return out


def _kernel(listing: str, kernel: str):
    """(sections, the kernel's instructions, {label: index}, {address:
    index}) of a listing."""
    secs = _sections(listing)
    insns, labels = [], {}
    for name, (ins, labs) in secs.items():
        if kernel in name:
            labels.update({k: v + len(insns) for k, v in labs.items()})
            insns += ins
    if not insns:
        raise ValueError(f"no SASS for {kernel}")
    return secs, insns, labels, {ins[0]: i for i, ins in enumerate(insns)}


def _with_calls(secs, insns, labels, addr_index, block) -> tuple[list, int]:
    """A block's instructions with each CALL's callee, to its RET, after
    the CALL; and how many of them the callees gave."""
    body, called = [], 0
    for ins in block:
        body.append(ins)
        if ins[1].startswith("CALL"):
            sub = _callee(secs, insns, labels, addr_index, ins[2])
            body += sub
            called += len(sub)
    return body, called


def _stats(body: list, called: int) -> dict:
    """n, depth, called, clocks, ops, forms and load_rounds of a block in
    issue order.  load_rounds: the most global loads (LDG) on one chain of
    dependences, where a guarded instruction also reads its guard and a
    guarded branch makes every later instruction depend on its guard: the
    memory round trips a thread waits for in series (depth counts the
    registers an instruction reads, not its guard)."""
    ops, forms, depth, writer, rounds, ctrl = {}, {}, 0, {}, {}, 0
    for _, op, args, _, guard in body:
        base = op.split(".")[0]
        ops[base] = ops.get(base, 0) + 1
        forms[op] = forms.get(op, 0) + 1
        regs = _REG.findall(args)
        dests = [] if base in _NO_DEST or not regs else regs[:1]
        srcs = regs[1:] if dests else regs
        d = 1 + max((writer.get(x, 0) for x in srcs), default=0)
        r = max([ctrl] + [rounds.get(x, 0) for x in srcs + [guard]]) + (base == "LDG")
        for x in dests:
            writer[x], rounds[x] = d, r
        if base == "BRA" and guard:
            ctrl = r
        depth = max(depth, d)
    return dict(n=len(body), depth=depth, called=called,
                clocks=sum(ins[3] for ins in body),
                load_rounds=max(rounds.values(), default=0),
                ops=dict(sorted(ops.items(), key=lambda kv: -kv[1])),
                forms=dict(sorted(forms.items(), key=lambda kv: -kv[1])))


def loops(listing: str, kernel: str) -> list[dict]:
    """[{"n": instructions, "depth": longest dependent chain, "ops": {opcode:
    count}, "forms": {opcode with its modifiers: count}, "called":
    instructions of it in called functions, "clocks": its stalls summed,
    the least clocks one warp alone takes an iteration (scoreboard waits
    and pipe conflicts add to it), "load_rounds" as in _stats}] for each
    loop of `kernel` in a cuobjdump -sass listing, in address order.  A
    CALL in the loop counts the callee's instructions to its RET as the
    loop's."""
    secs, insns, labels, addr_index = _kernel(listing, kernel)
    out = []
    for i, ins in enumerate(insns):
        if not ins[1].startswith("BRA"):
            continue
        start = _target(ins[2], labels, addr_index)
        if start is None or start >= i:  # forward, or the branch to itself after EXIT
            continue
        out.append(_stats(*_with_calls(secs, insns, labels, addr_index, insns[start:i + 1])))
    return out


def whole(listing: str, kernel: str) -> dict:
    """The whole of `kernel` as one block in address order, each CALL
    counting its callee to the RET where it is called (a subroutine in the
    kernel's own listing is not counted again where it sits): the dict of
    `loops`' entries.  For a kernel without loops, whose time is one pass:
    load_rounds says how many memory round trips a thread waits for in
    series."""
    secs, insns, labels, addr_index = _kernel(listing, kernel)
    sub = set()
    for ins in insns:
        start = _target(ins[2], labels, addr_index) if ins[1].startswith("CALL") else None
        for k in range(start if start is not None else len(insns), len(insns)):
            sub.add(k)
            if insns[k][1].startswith("RET"):
                break
    block = [ins for k, ins in enumerate(insns) if k not in sub]
    return _stats(*_with_calls(secs, insns, labels, addr_index, block))


def main(argv: list[str]) -> int:
    key = "forms" if "--forms" in argv else "ops"
    as_whole = "--whole" in argv
    argv = [a for a in argv if a not in ("--forms", "--whole")]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    kernel = argv[1]
    for so in [argv[0], *argv[2:]]:
        listing = dump(so)
        blocks = ([("whole", whole(listing, kernel))] if as_whole
                  else [(f"loop {i}", lp) for i, lp in enumerate(loops(listing, kernel))])
        for label, lp in blocks:
            called = f" ({lp['called']} in called functions)" if lp["called"] else ""
            print(f"{so} {kernel} {label}: {lp['n']} instructions{called}, longest dependent"
                  f" chain {lp['depth']}, {lp['clocks']} stall clocks, global loads in"
                  f" series {lp['load_rounds']}; "
                  + ", ".join(f"{op} {c}" for op, c in lp[key].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
