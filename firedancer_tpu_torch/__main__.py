"""The port's command line; every command runs on the card unless --cpu.

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
    python -m firedancer_tpu_torch warmup [--devices N] [--assert-warm S]
        build and load the serving plane's kernels and run one step at its
        shapes (the counterpart of the JAX package's AOT warmup); prints the
        same JSON keys, and --assert-warm S exits 2 when it took longer.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_run(args) -> int:
    from .models.leader import build_sharded_verify_pipeline, build_verify_pipeline
    from .runtime.benchg import gen_transfer_pool
    from .utils.platform import device_name, resolve_device

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
    pipe.run()
    run_s = time.perf_counter() - t0
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
    args = ap.parse_args(argv)
    if args.cmd == "warmup":
        return cmd_warmup(args)
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
