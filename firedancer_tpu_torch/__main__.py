"""The port's command line; every command that drives a device runs on the
card unless --cpu.

    python -m firedancer_tpu_torch run --txns N [--shards S] [--comb-slots N]
            [--kernel fused|baseline|split] [--autotune-after N] [--cpu]
        drive benchg -> verify -> dedup -> sink (with --shards S: through
        the router and the serving plane over S devices; with --comb-slots
        N: repeat signers through an N-slot comb bank; --kernel picks the
        verify lane's rung; --autotune-after N retunes the batch geometry
        every N batches) and print per-stage counters and txn/s with the
        device's name.
    python -m firedancer_tpu_torch run --leader --txns N [--shards S]
            [--banks B] [--hashes-per-tick H] [--pack-depth D] [--cpu]
        produce one slot's block: benchg -> verify -> dedup -> pack ->
        bank xB -> poh -> shred -> store (with --shards S, the verify
        stage, the PoH tick spans and the shredder's parity ride the
        serving plane), then seal; print the stage counters, the store's
        set count and the sha256 of its entry-batch bytes, the bank hash,
        txn/s to the store and the host seconds per stage.
    python -m firedancer_tpu_torch run --processes [--sandbox] --txns N
            [--batch B] [--cpu]
        the leader as one spawned process a stage (models/leader_topo.py:
        benchg -> verify -> pack -> bank -> poh -> shred -> store over shm
        links, supervised through their cncs; --sandbox jails every child:
        the seccomp deny list with threads allowed, and rlimits); runs until
        bank0 has executed the N txns and the store has a FEC set, then
        prints the monitor table and halts.  Exit 1 when a stage failed.
    python -m firedancer_tpu_torch warmup [--devices N] [--assert-warm S]
        build and load the serving plane's kernels and run one step at its
        shapes (the counterpart of the JAX package's AOT warmup); prints the
        same JSON keys, and --assert-warm S exits 2 when it took longer.

The commands that watch a running topology from another process attach
through its run descriptor (runtime/monitor.py; --descriptor PATH, else
the newest live run under build/torch_run); each exits 1 when there is
nothing to attach to:

    monitor [--interval S] [--iterations N]
        the live per-stage table (shards folded into one row a stage kind).
    ready [--timeout S]
        exit 0 once every stage heartbeats in RUN, 1 on a timeout or a FAIL.
    metrics [--once | --serve PORT]
        the Prometheus text of every stage's shm registry (sharded stages
        labelled {stage=<kind>,shard=<i>}), printed once or served over HTTP.
    trace [--dump FILE | --descriptor PATH] [--out FILE]
        the flight rings as Chrome trace JSON (default build/torch_run/
        trace.json): from a supervisor's flight dump, a live run, or the
        newest dump.
    slotreport [--dump FILE ...] [--normalize] [--out FILE]
        the per-slot report (runtime/slot_report.py) of a live run or of
        flight dumps (several: one aggregate).
    chaos list | chaos run <scenario> [--seed S] [--duration S] [--cpu]
        the chaos harness (chaos/scenario.py): only the deterministic
        summary goes to stdout; exit 1 when an invariant is violated, 2 for
        a scenario the port does not have.  --cpu runs slot-overrun's
        children on the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _run_processes(args) -> int:
    """One process a stage, supervised; the monitor table at the end."""
    from .models.leader_topo import build_leader_topology
    from .runtime import topo as ft

    sandbox = {"rlimits": {"nofile": 512}} if args.sandbox else None
    topo = build_leader_topology(n_txns=args.txns, pool_size=args.txns, batch=args.batch,
                                 max_msg_len=args.max_msg_len, sandbox=sandbox,
                                 device="cpu" if args.cpu else None)
    h = ft.launch(topo)
    try:
        print(f"# {len(h.procs)} stage processes; descriptor fdtpu_torch_run_{h.uid}.json"
              + (" (sandboxed)" if sandbox else ""), file=sys.stderr)
        t0 = time.perf_counter()
        ok = h.supervise(until=lambda h: h.met_views["bank0"][0].get("txn_exec") >= args.txns
                         and h.met_views["store"][0].get("sets_stored") > 0,
                         timeout_s=600, heartbeat_timeout_s=60)
        run_s = time.perf_counter() - t0
        print(h.format_monitor())
        print(f"# {h.met_views['bank0'][0].get('txn_exec')} txns executed in {run_s:.2f} s;"
              f" {h.met_views['store'][0].get('sets_stored')} FEC sets stored"
              + ("" if ok else f"; stage {h.failed} failed"))
        h.halt()
        return 0 if ok else 1
    finally:
        h.close()


def cmd_run(args) -> int:
    from .models.leader import build_sharded_verify_pipeline, build_verify_pipeline
    from .runtime.benchg import gen_transfer_pool
    from .utils.platform import device_name, resolve_device

    if args.sandbox and not args.processes:
        print("run: --sandbox jails the children of --processes", file=sys.stderr)
        return 2
    if args.processes:
        if args.leader or args.shards or args.comb_slots or args.kernel != "fused" \
                or args.autotune_after:
            print("run: --processes runs the leader topology's default lanes (no --leader,"
                  " --shards, --comb-slots, --kernel or --autotune-after)", file=sys.stderr)
            return 2
        return _run_processes(args)
    if args.leader:
        if args.comb_slots or args.kernel != "fused" or args.autotune_after:
            print("run: --leader drives the fused verify lane (no --comb-slots,"
                  " --kernel or --autotune-after)", file=sys.stderr)
            return 2
        from .entry import leader_block

        pool = gen_transfer_pool(args.txns, seed=args.seed.encode())
        out = leader_block(pool, device="cpu" if args.cpu else None,
                           shards=args.shards, batch=args.batch,
                           max_msg_len=args.max_msg_len, n_bank=args.banks,
                           hashes_per_tick=args.hashes_per_tick,
                           pack_depth=args.pack_depth)
        print(json.dumps(out, indent=1))
        return 0
    if args.shards and (args.comb_slots or args.kernel != "fused" or args.autotune_after):
        print("run: --comb-slots, --kernel and --autotune-after need the"
              " unsharded pipeline (the serving plane's step is its kernel"
              " choice)", file=sys.stderr)
        return 2
    dev = resolve_device("cpu" if args.cpu else None)
    t0 = time.perf_counter()
    pool = gen_transfer_pool(args.txns, seed=args.seed.encode())
    gen_s = time.perf_counter() - t0
    warmup_s = None
    if args.shards:
        pipe = build_sharded_verify_pipeline(
            pool, n_shards=args.shards, device=dev, batch_per_shard=args.batch,
            max_msg_len=args.max_msg_len)
        # build and load the kernels before the timed run, as a leader
        # warms its plane before its slot
        warmup_s = pipe.verify.plane.warmup()
    else:
        pipe = build_verify_pipeline(pool, device=dev, batch=args.batch,
                                     max_msg_len=args.max_msg_len,
                                     comb_slots=args.comb_slots, kernel=args.kernel,
                                     autotune_after=args.autotune_after)
    t0 = time.perf_counter()
    try:
        pipe.run()
        run_s = time.perf_counter() - t0
    finally:
        pipe.close()
    out = {
        "device": device_name(dev),
        "shards": args.shards or None,
        "comb_slots": args.comb_slots,
        "kernel": args.kernel,
        "txns": args.txns,
        "pool_gen_s": gen_s,
        "warmup_s": warmup_s,
        "run_s": run_s,
        "txn_per_s": pipe.sink.metrics.get("txn_sunk") / run_s,
        "stages": pipe.report(),
    }
    print(json.dumps(out, indent=1))
    return 0


def cmd_warmup(args) -> int:
    from .parallel.serve import ServeConfig, ServePlane
    from .utils import kbuild

    cfg = ServeConfig(
        n_devices=args.devices,
        batch_per_shard=args.batch_per_shard,
        max_msg_len=args.max_msg_len,
        poh_iters=args.poh_iters,
    )
    plane = ServePlane(cfg, device="cpu" if args.cpu else None)
    compile_s = plane.warmup()
    print(json.dumps({
        "serve_step": cfg.cache_key(),
        "devices": args.devices,
        "batch": cfg.batch,
        "compile_s": round(compile_s, 2),
        "cache_dir": None if args.cpu else kbuild.build_dir(),
    }))
    if args.assert_warm is not None and compile_s > args.assert_warm:
        print(f"warmup: build/load took {compile_s:.1f}s "
              f"> --assert-warm {args.assert_warm}s (cache miss?)",
              file=sys.stderr)
        return 2
    return 0


def _attach(cmd: str, descriptor):
    """A MonitorSession on the descriptor (or the newest live run), or None
    after saying why on stderr."""
    from .runtime.monitor import MonitorSession

    try:
        return MonitorSession.attach(descriptor)
    except (RuntimeError, OSError, ValueError) as e:
        print(f"{cmd}: {e}", file=sys.stderr)
        return None


def cmd_monitor(args) -> int:
    ses = _attach("monitor", args.descriptor)
    if ses is None:
        return 1
    try:
        ses.run(interval_s=args.interval, iterations=args.iterations)
    finally:
        ses.close()
    return 0


def cmd_ready(args) -> int:
    ses = _attach("ready", args.descriptor)
    if ses is None:
        return 1
    try:
        ok = ses.wait_ready(timeout_s=args.timeout)
    finally:
        ses.close()
    print("ready" if ok else "not ready")
    return 0 if ok else 1


def cmd_metrics(args) -> int:
    """The metrics endpoint's position: a process the topology does not
    know of reads its shm registries and prints or serves the text."""
    ses = _attach("metrics", args.descriptor)
    if ses is None:
        return 1
    try:
        if not ses.registries():
            print("metrics: the run exposes no metrics segments", file=sys.stderr)
            return 1
        if args.once:
            sys.stdout.write(ses.scrape())
            return 0
        from .utils.metrics import MetricsServer

        def resolve():
            # every scrape: a replaced run (or a segment that joined late)
            # is followed, not served stale
            ses.refresh()
            return ses.registries(), ses.shard_labels()

        srv = MetricsServer(ses.registries(), port=args.serve, labels=ses.shard_labels(),
                            resolver=resolve)
        try:
            host, port = srv.addr
            print(f"# serving /metrics on http://{host}:{port}/ (^C exits)", file=sys.stderr)
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                pass
        finally:
            srv.close()
        return 0
    finally:
        ses.close()


def _dump_of(dump: str | None, descriptor: str | None, reason: str) -> dict:
    """The flight dump a command reads: the file `dump`, a live snapshot of
    the descriptor's (or the newest) run, or the newest dump on disk."""
    from .runtime import monitor as mon

    if dump is not None:
        with open(dump) as f:
            return json.load(f)
    if descriptor is not None or mon.list_runs():
        ses = mon.MonitorSession.attach(descriptor)
        try:
            return ses.flight_dump(reason)
        finally:
            ses.close()
    dumps = mon.list_flight_dumps()
    if not dumps:
        raise RuntimeError("no live run and no flight dumps found")
    print(f"# using newest flight dump {dumps[0]}", file=sys.stderr)
    with open(dumps[0]) as f:
        return json.load(f)


def cmd_trace(args) -> int:
    from .utils.metrics import flight_to_chrome_trace

    try:
        dump = _dump_of(args.dump, args.descriptor, "live snapshot")
    except (RuntimeError, OSError, ValueError) as e:
        print(f"trace: {e}", file=sys.stderr)
        return 1
    trace = flight_to_chrome_trace(dump)
    out = args.out
    if out is None:
        from .runtime.monitor import RUN_DIR

        os.makedirs(RUN_DIR, exist_ok=True)
        out = os.path.join(RUN_DIR, "trace.json")
    with open(out, "w") as f:
        json.dump(trace, f)
    print(f"# wrote {len(trace['traceEvents'])} trace events to {out}", file=sys.stderr)
    return 0


def cmd_slotreport(args) -> int:
    from .runtime import slot_report as sr

    try:
        if args.dump and len(args.dump) > 1:
            rep = sr.aggregate_reports([sr.build_report(_dump_of(p, None, ""))
                                        for p in args.dump])
        else:
            rep = sr.build_report(_dump_of(args.dump[0] if args.dump else None,
                                           args.descriptor, "slotreport"))
    except (RuntimeError, OSError, ValueError) as e:
        print(f"slotreport: {e}", file=sys.stderr)
        return 1
    if args.normalize:
        rep = sr.normalize(rep)
    text = sr.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"# wrote slot report to {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(text)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m firedancer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="drive benchg -> verify -> dedup -> sink"
                       " (--leader: on to pack -> bank -> poh -> shred -> store)")
    r.add_argument("--txns", type=int, default=2048)
    r.add_argument("--batch", type=int, default=1024,
                   help="verify batch (per shard with --shards)")
    r.add_argument("--shards", type=int, default=0,
                   help="route through the serving plane over this many devices")
    r.add_argument("--comb-slots", type=int, default=0,
                   help="comb-bank slots for repeat signers (0 = off)")
    r.add_argument("--kernel", default="fused", choices=("fused", "baseline", "split"),
                   help="the verify lane's rung of the kernel ladder")
    r.add_argument("--autotune-after", type=int, default=0, metavar="N",
                   help="retune batch and max_msg_len every N batches (0 = off)")
    r.add_argument("--leader", action="store_true",
                   help="produce a block: ... -> pack -> bank -> poh -> shred -> store")
    r.add_argument("--processes", action="store_true",
                   help="the leader as one supervised process a stage (models/leader_topo.py)")
    r.add_argument("--sandbox", action="store_true",
                   help="with --processes: jail every stage (seccomp deny list, rlimits)")
    r.add_argument("--banks", type=int, default=2, help="bank stages (--leader)")
    r.add_argument("--hashes-per-tick", type=int, default=64,
                   help="PoH hashes per tick and the plane's span (--leader --shards)")
    r.add_argument("--pack-depth", type=int, default=4096,
                   help="pack's pending pool (--leader)")
    r.add_argument("--max-msg-len", type=int, default=1232)
    r.add_argument("--seed", default="benchg")
    r.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the host")
    w = sub.add_parser("warmup", help="build and warm the serving plane")
    w.add_argument("--devices", type=int, default=1)
    w.add_argument("--batch-per-shard", type=int, default=32)
    w.add_argument("--max-msg-len", type=int, default=256)
    w.add_argument("--poh-iters", type=int, default=64)
    w.add_argument("--assert-warm", type=float, default=None, metavar="S",
                   help="exit 2 if the warmup took longer than S seconds")
    w.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the host")
    m = sub.add_parser("monitor", help="live per-stage table of a running topology")
    m.add_argument("--descriptor", default=None,
                   help="run descriptor path (default: the newest live run)")
    m.add_argument("--interval", type=float, default=1.0)
    m.add_argument("--iterations", type=int, default=None,
                   help="redraws (default: until ^C)")
    rd = sub.add_parser("ready", help="block until every stage heartbeats in RUN")
    rd.add_argument("--descriptor", default=None)
    rd.add_argument("--timeout", type=float, default=60.0)
    mt = sub.add_parser("metrics", help="Prometheus text of a running topology's registries")
    mt.add_argument("--descriptor", default=None,
                    help="run descriptor path (default: the newest live run)")
    g = mt.add_mutually_exclusive_group()
    g.add_argument("--once", action="store_true", help="print one exposition and exit")
    g.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="serve /metrics over HTTP (0 = an ephemeral port)")
    tr = sub.add_parser("trace", help="flight rings -> Chrome trace JSON")
    tr.add_argument("--out", default=None,
                    help="the trace file (default: trace.json under build/torch_run)")
    tr.add_argument("--dump", default=None,
                    help="a supervisor's flight dump (default: a live run, else the newest dump)")
    tr.add_argument("--descriptor", default=None, help="run descriptor of the live run")
    sr = sub.add_parser("slotreport", help="per-slot JSON report: seals and misses, sweep"
                        " phases, native lanes and punts, funk writes, restarts")
    sr.add_argument("--descriptor", default=None, help="run descriptor of the live run")
    sr.add_argument("--dump", nargs="+", default=None, metavar="DUMP",
                    help="flight dump file(s); several -> one aggregate report")
    sr.add_argument("--out", default=None, help="write the JSON here (default: stdout)")
    sr.add_argument("--normalize", action="store_true",
                    help="strip the timing-dependent fields (determinism diffs)")
    ch = sub.add_parser("chaos", help="scenario harness: faults, load and invariants")
    ch.add_argument("action", choices=["run", "list"])
    ch.add_argument("scenario", nargs="?", default=None, help="scenario name (see chaos list)")
    ch.add_argument("--seed", type=int, default=0,
                    help="run seed; the same seed gives the same summary")
    ch.add_argument("--duration", type=float, default=None,
                    help="wall-clock budget in seconds (the scenario's default if omitted)")
    ch.add_argument("--cpu", action="store_true",
                    help="slot-overrun: run its children's plain versions on the host")
    args = ap.parse_args(argv)
    if args.cmd == "warmup":
        return cmd_warmup(args)
    if args.cmd == "chaos":
        from .chaos import scenario as _chaos

        return _chaos.main(args)
    cmd = {"monitor": cmd_monitor, "ready": cmd_ready, "metrics": cmd_metrics,
           "trace": cmd_trace, "slotreport": cmd_slotreport}.get(args.cmd, cmd_run)
    return cmd(args)


if __name__ == "__main__":
    sys.exit(main())
