"""Phase 17k of chip_smoke.py, A/B over source trees, on one card.

    python3 leader_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository (an earlier commit unpacked
with `git archive`, or `.` for this one).  For each, in the order given
and in a process of its own with that tree first on sys.path, it builds
the leader's kernels and host libraries, makes phase 17's pool of 8,192
transfers, then runs the tree's own chip_smoke.leader_in_process (the
leader in one process, one bank, 16 slots of 400 ms) twice, the first as
a warm-up, and its chip_smoke.leader_as_processes (models/leader_topo's
topology, one spawned process a stage) once.  Name a tree twice to see
the spread (parent, change, change, parent).

Prints one JSON line per run and, before the last, the card's name and
power limit as nvidia-smi gives them; the last line is a JSON list of the
runs: the in-process txn/s to the last landing, the topology's txn/s
from the clock's anchor to the last landing, verify0's batches and K1
launches, the slots sealed and missed, and each child's boot seconds.
Exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = r"""
import json, os, sys, time
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
from firedancer_tpu_torch.models import leader_topo as lt
from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
from firedancer_tpu_torch.runtime.slot_clock import SlotClockCfg
from firedancer_tpu_torch.utils import hostbuild, kbuild

t0 = time.perf_counter()
kbuild.build_all(list(lt.KERNELS))
for n_ in lt.HOST_LIBS:
    hostbuild.build(n_)
build_s = time.perf_counter() - t0
dev = torch.device("cuda")
pool = gen_transfer_pool(cs.LEADER_TXNS, n_payers=8, n_dests=cs.LEADER_DESTS)
clock = SlotClockCfg(slot_ms=cs.CLOCK_SLOT_MS, slot0=1, ticks_per_slot=cs.CLOCK_TICKS,
                     n_slots=cs.CLOCK_SLOTS, miss_grace_frac=cs.CLOCK_GRACE)
B1, ML1 = 1024, 1232
warm = cs.leader_in_process(pool, dev, clock, B1, ML1)
inp = cs.leader_in_process(pool, dev, clock, B1, ML1)
cs.check(inp["landed"] == len(pool), f"in process: landed {inp['landed']}")
r = cs.leader_as_processes(pool, dev, clock, B1, ML1, cs.TOPO_BOOT_GRACE_S)
c = r["counters"]
cs.check(c["bank0"]["txn_exec"] == len(pool), f"as processes: {c['bank0']}")
print(json.dumps({
    "tree": sys.argv[1], "build_s": build_s,
    "in_process": {"txn_s": inp["txn_s"], "all_s": inp["all_s"], "in_window": inp["in_window"],
                   "sealed": inp["sealed"], "missed": inp["missed"],
                   "warmup_txn_s": warm["txn_s"]},
    "processes": {"txn_s": c["bank0"]["txn_exec"] / r["landed_s"], "landed_s": r["landed_s"],
                  "window_s": r["window_s"], "in_window": r["in_window"],
                  "verify0_batches": c["verify0"]["batches"],
                  "verify0_k1": c["verify0"]["k1_launches"],
                  "sealed": c["poh"]["slots_sealed"], "missed": c["poh"]["slot_missed"],
                  "boot_s": {k: v["boot_s"] for k, v in r["snap"].items()}},
}), flush=True)
"""


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or not argv:
        print("leader_ab: needs a CUDA device and at least one tree", file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        p = subprocess.run([sys.executable, "-c", _RUN, tree], capture_output=True, text=True,
                           timeout=900)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(f"leader_ab: the run over {tree} exited {p.returncode}", file=sys.stderr)
            return 1
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no answer")
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
