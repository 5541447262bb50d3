"""`python -m firedancer_tpu_torch run --txns N [--cpu]`: drive the verify
slice (benchg -> verify -> dedup -> sink) and print per-stage counters and
txn/s with the device's name.  Runs on the card unless --cpu is given."""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_run(args) -> int:
    from .models.leader import build_verify_pipeline
    from .runtime.benchg import gen_transfer_pool
    from .utils.platform import device_name, resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    t0 = time.perf_counter()
    pool = gen_transfer_pool(args.txns, seed=args.seed.encode())
    gen_s = time.perf_counter() - t0
    pipe = build_verify_pipeline(pool, device=dev, batch=args.batch,
                                 max_msg_len=args.max_msg_len)
    t0 = time.perf_counter()
    pipe.run()
    run_s = time.perf_counter() - t0
    out = {
        "device": device_name(dev),
        "txns": args.txns,
        "pool_gen_s": gen_s,
        "run_s": run_s,
        "txn_per_s": pipe.sink.metrics.get("txn_sunk") / run_s,
        "stages": pipe.report(),
    }
    print(json.dumps(out, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m firedancer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="drive benchg -> verify -> dedup -> sink")
    r.add_argument("--txns", type=int, default=2048)
    r.add_argument("--batch", type=int, default=1024)
    r.add_argument("--max-msg-len", type=int, default=1232)
    r.add_argument("--seed", default="benchg")
    r.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the host")
    args = ap.parse_args(argv)
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
