"""Invariant checker: what must hold after (and during) every scenario
(the port's copy of firedancer_tpu/chaos/invariants.py).

A scenario accumulates named checks into an `InvariantSuite`; the
suite's `summary()` is DETERMINISTIC for a given seed — booleans, counts
and hashes only, never wall-clock quantities — because identical
summaries across runs is the harness's acceptance contract.

The check families (the tentpole's list):
  liveness          the pipeline drained / heartbeats stayed fresh
  bank integrity    the wire entries replay to the sealed bank hash on a
                    fresh bank (flamenco/runtime.replay_block — the
                    golden replay)
  conservation      accepted-txn counts reconcile across hops, local
                    (stage Metrics) or scraped from the shm metric
                    registries of a live process topology
  no-corruption     payload sets survive the trip byte-identically
  reclaim           close() leaves no /dev/shm residue

Left out with the cluster scenarios (the validator's): the cluster-wide,
turbine and choreo checks.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field


class InvariantViolation(AssertionError):
    """Raised by `InvariantSuite.require` when a scenario opts into
    fail-fast; carries the failing check for the artifact path."""

    def __init__(self, name: str, detail: str = ""):
        super().__init__(f"invariant '{name}' violated: {detail}")
        self.name = name
        self.detail = detail


@dataclass
class CheckResult:
    name: str
    ok: bool
    detail: str = ""  # human context; NOT part of the deterministic summary


@dataclass
class InvariantSuite:
    checks: list[CheckResult] = field(default_factory=list)

    def check(self, name: str, ok: bool, detail: str = "") -> bool:
        self.checks.append(CheckResult(name, bool(ok), detail))
        return bool(ok)

    def require(self, name: str, ok: bool, detail: str = "") -> None:
        if not self.check(name, ok, detail):
            raise InvariantViolation(name, detail)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def violations(self) -> list[CheckResult]:
        return [c for c in self.checks if not c.ok]

    def summary(self) -> dict:
        """Deterministic: check names -> booleans, sorted."""
        return {c.name: c.ok for c in sorted(self.checks, key=lambda c: c.name)}

    def describe(self) -> str:
        return "\n".join(
            f"  [{'ok' if c.ok else 'VIOLATED'}] {c.name}"
            + (f": {c.detail}" if c.detail and not c.ok else "")
            for c in self.checks
        )


# -- cooperative-pipeline checks ----------------------------------------------


def check_pipeline_conservation(suite: InvariantSuite, report: dict,
                                n_expected: int, *, prefix: str = "") -> None:
    """Accepted-txn conservation across the leader pipeline's hops, from
    a LeaderPipeline.report() dict: every txn the generator emitted is
    accounted for at every stage — verified or explained (parse/verify
    fail, duplicate), scheduled, executed, and every microblock's lock
    released."""
    p = prefix
    gen = report["benchg"].get("txn_gen", 0)
    ver = sum(v.get("txn_verified", 0) for k, v in report.items()
              if k.startswith("verify"))
    explained = sum(
        v.get("parse_fail", 0) + v.get("verify_fail", 0)
        + v.get("msg_too_long", 0) + v.get("too_many_sigs", 0)
        + v.get("dedup_dup", 0)
        for k, v in report.items() if k.startswith("verify")
    )
    suite.check(f"{p}verify-accounts-for-generated",
                ver + explained == gen,
                f"verified {ver} + explained {explained} != generated {gen}")
    # the fused native pack lane counts dedup drops at pack (there is no
    # dedup stage in that topology); the python lane at the dedup stage
    dedup_dup = (report.get("dedup", {}).get("dedup_dup", 0)
                 + report.get("pack", {}).get("dedup_dup", 0))
    pack_in = report.get("pack", {}).get("txn_in", 0)
    suite.check(f"{p}dedup-conserves", pack_in + dedup_dup == ver,
                f"pack_in {pack_in} + dups {dedup_dup} != verified {ver}")
    sched = report.get("pack", {}).get("txn_scheduled", 0)
    execs = sum(v.get("txn_exec", 0) + v.get("txn_rejected", 0)
                for k, v in report.items() if k.startswith("bank"))
    suite.check(f"{p}banks-account-for-scheduled", execs == sched,
                f"bank exec+rejected {execs} != scheduled {sched}")
    mbs = report.get("pack", {}).get("microblocks", 0)
    done = report.get("pack", {}).get("microblock_done", 0)
    suite.check(f"{p}microblock-locks-released", mbs == done,
                f"microblocks {mbs} != done {done}")
    suite.check(f"{p}expected-count-landed",
                sum(v.get("txn_exec", 0) for k, v in report.items()
                    if k.startswith("bank")) == n_expected,
                f"expected {n_expected} landed txns")


def check_bank_hash_golden(suite: InvariantSuite, *, entry_batch: bytes,
                           seal, slot: int, make_fresh_ctx,
                           parent_bank_hash: bytes = b"\x00" * 32,
                           parent_xid: bytes | None = None,
                           poh_seed: bytes = b"\x00" * 32,
                           prefix: str = "", device=None):
    """The golden replay: deshred the store's wire bytes, replay on a
    FRESH bank built by `make_fresh_ctx()`, and demand the identical
    bank hash the live pipeline sealed.  Returns the replay BlockResult
    (or None) so multi-slot scenarios can chain parents.  `device` is the
    replay's (None: the card; "cpu": the plain versions)."""
    from ..flamenco.runtime import replay_block
    from ..runtime.poh_stage import parse_entry
    from ..runtime.shred_stage import deshred_entry_batch

    entries = [parse_entry(e) for e in deshred_entry_batch(entry_batch)]
    ctx = make_fresh_ctx()
    res = replay_block(
        ctx.funk, slot=slot, entries=entries, poh_seed=poh_seed,
        parent_bank_hash=parent_bank_hash, parent_xid=parent_xid, device=device,
    )
    p = prefix
    if not suite.check(f"{p}poh-chain-verifies", res is not None,
                       "replay_entries rejected the PoH chain"):
        return None
    suite.check(f"{p}bank-hash-matches-golden-replay",
                res.bank_hash == seal.bank_hash,
                f"replay {res.bank_hash.hex()[:16]} != "
                f"sealed {seal.bank_hash.hex()[:16]}")
    suite.check(f"{p}signature-count-matches",
                res.signature_cnt == seal.signature_cnt,
                f"{res.signature_cnt} != {seal.signature_cnt}")
    return res


def payload_digest(payloads) -> str:
    """Order-independent digest of a payload multiset (the corruption
    check's deterministic summary form)."""
    h = hashlib.sha256()
    for p in sorted(payloads):
        h.update(len(p).to_bytes(4, "little"))
        h.update(p)
    return h.hexdigest()


def check_no_corruption(suite: InvariantSuite, sent, received, *,
                        prefix: str = "", allow_dupes: bool = True) -> None:
    """Every received payload is byte-identical to one that was sent
    (no frag corruption), and — unless duplicates are an injected fault
    — multiplicities match too."""
    p = prefix
    sent_set, recv_set = set(sent), set(received)
    suite.check(f"{p}no-frag-corruption", recv_set <= sent_set,
                f"{len(recv_set - sent_set)} unknown payload(s) received")
    if not allow_dupes:
        suite.check(f"{p}no-unexplained-loss-or-dup",
                    sorted(sent) == sorted(received),
                    f"sent {len(sent)} != received {len(received)}")


# -- process-topology checks --------------------------------------------------


def check_heartbeats_fresh(suite: InvariantSuite, handle, *,
                           max_age_s: float = 5.0,
                           prefix: str = "") -> None:
    """Liveness: every stage alive, in RUN, heartbeat younger than
    `max_age_s` (the cnc contract the supervisor enforces)."""
    from ..tango.rings import CNC_SIG_RUN

    rows = handle.snapshot()
    stale = [
        r["stage"] for r in rows
        if not r["alive"] or r["signal"] != CNC_SIG_RUN
        or r["heartbeat_age_ms"] is None
        or r["heartbeat_age_ms"] > max_age_s * 1e3
    ]
    suite.check(f"{prefix}heartbeats-fresh", not stale,
                f"stale/dead stages: {stale}")


def check_registry_conservation(suite: InvariantSuite, handle, *,
                                producer: str, consumer: str,
                                prefix: str = "") -> None:
    """Conservation scraped from the shm metric registries of a
    LIVE topology: at a quiescent point, everything the producer
    published reached the consumer (minus the ring's own overrun loss,
    which the consumer counts).  Call only after waiting for the
    consumer's counters to stop moving — registry values are housekeeping
    -flushed and may lag a lazy interval during flight."""
    regs = {name: reg for name, (reg, _rec) in handle.met_views.items()}
    out = regs[producer].get("frags_out")
    got = regs[consumer].get("frags_in")
    lost = regs[consumer].get("overrun")
    filt = regs[consumer].get("filtered")
    if lost:
        # an overrun event can swallow a variable frag count: the exact
        # reconciliation is only defined when the ring never lapped
        ok = got + filt <= out
    else:
        ok = got + filt == out
    suite.check(f"{prefix}shm-registry-conservation", ok,
                f"{producer}.frags_out={out} vs {consumer}: "
                f"in={got} filtered={filt} overrun={lost}")


def check_shm_reclaimed(suite: InvariantSuite, shm_names, *,
                        prefix: str = "") -> None:
    """After close(): none of the topology's segments survive in
    /dev/shm (a leaked segment outlives the process and eventually fills
    the host — the reclaim half of crash containment)."""
    leaked = [n for n in shm_names if os.path.exists(os.path.join(
        "/dev/shm", n))]
    suite.check(f"{prefix}shm-reclaimed", not leaked,
                f"leaked /dev/shm segments: {leaked}")
