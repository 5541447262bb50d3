"""The run descriptor and the flight-dump files of a process topology (the
pieces of firedancer_tpu/runtime/monitor.py that runtime/topo.py calls).

A launched topology advertises itself in a run descriptor,
`fdtpu_torch_run_<uid>.json` under RUN_DIR: the stage names, their cnc and
metrics segment names, and each metrics schema, so another process can
attach.  A supervisor that fails a topology writes
`fdtpu_torch_flight_<uid>.json` there; dumps outlive their runs (they are
the evidence).  RUN_DIR is the checkout's build/torch_run folder.

The monitor session, the TUI and the ready and metrics commands are not
ported yet.
"""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUN_DIR = os.path.join(ROOT, "build", "torch_run")

def descriptor_path(uid: str) -> str:
    return os.path.join(RUN_DIR, f"fdtpu_torch_run_{uid}.json")


def flight_dump_path(uid: str) -> str:
    return os.path.join(RUN_DIR, f"fdtpu_torch_flight_{uid}.json")


def list_flight_dumps() -> list[str]:
    """Flight dump paths, newest first."""
    if not os.path.isdir(RUN_DIR):
        return []
    out = [os.path.join(RUN_DIR, fn) for fn in os.listdir(RUN_DIR)
           if fn.startswith("fdtpu_torch_flight_") and fn.endswith(".json")]
    return sorted(out, key=os.path.getmtime, reverse=True)


def write_descriptor(uid: str, stages: dict[str, str], metrics: dict | None = None) -> str:
    """stages: name -> cnc segment name; metrics: name -> {"shm": metrics
    segment name, "schema": schema_to_obj(...)}.  Written atomically;
    returns the path."""
    os.makedirs(RUN_DIR, exist_ok=True)
    path = descriptor_path(uid)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"uid": uid, "pid": os.getpid(), "stages": stages,
                   "metrics": metrics or {}}, f)
    os.replace(tmp, path)
    return path


def remove_descriptor(uid: str) -> None:
    try:
        os.remove(descriptor_path(uid))
    except OSError:
        pass
