"""The loops of a built kernel, read from its SASS (cuobjdump -sass).

For each backward branch of one kernel: the instructions from its target
to the branch, counted by opcode, and the longest chain of instructions
each reading a register the one before wrote.  A vector load's or store's
registers count from its first; a loop's live-in registers start at depth
0.  The counts are what a warp running the loop issues an iteration, and
what its dependent instructions are: the latencies themselves are not in
the listing.

    python -m firedancer_tpu_torch.utils.sass LIB.so KERNEL [LIB.so ...]

prints each library's loops of KERNEL (cuobjdump from the CUDA toolkit
that kbuild uses).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_REG = re.compile(r"\b(U?R[0-9]+|U?P[0-6])\b")
_LABEL = re.compile(r"\s*(\.L_x_[0-9]+):")
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


def loops(listing: str, kernel: str) -> list[dict]:
    """[{"n": instructions, "depth": longest dependent chain, "ops": {opcode:
    count}}] for each loop of `kernel` in a cuobjdump -sass listing, in
    address order."""
    insns, labels, body = [], {}, False
    for line in listing.splitlines():
        if "Function :" in line:
            body = kernel in line
            continue
        if not body:
            continue
        lab = _LABEL.match(line)
        if lab:
            labels[lab.group(1)] = len(insns)
            continue
        m = _INSN.search(line)
        if m:
            insns.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if not insns:
        raise ValueError(f"no SASS for {kernel}")
    addr_index = {a: i for i, (a, _, _) in enumerate(insns)}
    out = []
    for i, (_, op, args) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        tgt = re.search(r"\(?(\.L_x_[0-9]+)\)?", args)
        start = labels.get(tgt.group(1)) if tgt else None
        if start is None:
            num = re.search(r"0x([0-9a-f]+)", args)
            start = addr_index.get(int(num.group(1), 16)) if num else None
        if start is None or start >= i:  # forward, or the branch to itself after EXIT
            continue
        ops, depth, writer = {}, 0, {}
        for _, op_, args_ in insns[start:i + 1]:
            base = op_.split(".")[0]
            ops[base] = ops.get(base, 0) + 1
            regs = _REG.findall(args_)
            dests = [] if base in _NO_DEST or not regs else regs[:1]
            srcs = regs[1:] if dests else regs
            d = 1 + max((writer.get(x, 0) for x in srcs), default=0)
            for x in dests:
                writer[x] = d
            depth = max(depth, d)
        out.append(dict(n=i + 1 - start, depth=depth,
                        ops=dict(sorted(ops.items(), key=lambda kv: -kv[1]))))
    return out


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    kernel = argv[1]
    for so in [argv[0], *argv[2:]]:
        for i, lp in enumerate(loops(dump(so), kernel)):
            print(f"{so} {kernel} loop {i}: {lp['n']} instructions, longest dependent"
                  f" chain {lp['depth']}; " + ", ".join(f"{op} {c}" for op, c in lp["ops"].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
