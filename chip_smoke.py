"""Drive the port's verify slice on one NVIDIA H100 and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a nonzero exit and no
result line:

  1. device   name, count, capability, nvidia-smi name and power limit
  2. build    nvcc builds csrc/*.cu (one process per source, in parallel)
  3. K2       fe_mul_chain at B = 16,384, k = 64: equal to the plain version
              (canonical limbs) and to Python ints on sampled lanes
  4. K3       sha512_batch at B = 4,096, max_len 1,296, lengths across the
              padding boundaries: equal to hashlib and the plain version
  5. K1       verify_batch at B = 1,024, max_msg_len 1,232 on a seeded mixed
              batch: mask equal to the plain version and to ed25519_ref
              labels, ok-count equal to the mask's sum
  6. K1 time  B = 16,384, max_msg_len 1,232, CUDA events; plain version too
  7. pipeline build_verify_pipeline (benchg -> verify -> dedup -> sink) at
              batch 1,024, max_msg_len 1,232: exact counters, K1 launched

Then one JSON line of per-kernel numbers ({"kernels": [...]}), the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}.
The script imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_CLK_PER_SM = 64  # 32-bit IMAD / IADD3 / LOP3 / SHF, sm_90
SHA512_OPS_PER_BLOCK = 4144  # 32-bit instructions per 128-byte block, 2 per 64-bit op


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time per call, CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an H100",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from firedancer_tpu_torch.models.leader import build_verify_pipeline
    from firedancer_tpu_torch.models.workload import mixed_batch, verify_stream
    from firedancer_tpu_torch.ops import limbs as fl
    from firedancer_tpu_torch.ops import sha512 as fsha
    from firedancer_tpu_torch.ops import sigverify as sv
    from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
    from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool
    from firedancer_tpu_torch.utils import kbuild
    from firedancer_tpu_torch.utils.platform import resolve_device

    t_start = time.perf_counter()
    # -- 1. device ------------------------------------------------------------
    dev = resolve_device()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    props = torch.cuda.get_device_properties(0)
    smi = nvidia_smi("name,power.limit")
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_ops_per_s = props.multi_processor_count * INT_OPS_PER_CLK_PER_SM * clk_mhz * 1e6
    log(f"[device] {name} count={count} capability={torch.cuda.get_device_capability(0)}"
        f" sms={props.multi_processor_count} max_sm_clock={clk_mhz} MHz"
        f" torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    kbuild.build_all()
    log(f"[build] {kbuild.kernel_names()} in {time.perf_counter() - t0:.1f} s"
        f" ({kbuild.build_dir()})")
    kernels = []

    # -- 3. K2 fe_mul_chain -------------------------------------------------------
    B2, K2 = 16384, 64
    rng = np.random.default_rng(2)
    xs = [int.from_bytes(rng.bytes(32), "little") % fl.P for _ in range(B2)]
    ys = [int.from_bytes(rng.bytes(32), "little") % fl.P for _ in range(B2)]
    x = torch.from_numpy(np.stack([fl.int_to_limbs(v) for v in xs], -1)).to(
        torch.int32).to(dev).contiguous()
    y = torch.from_numpy(np.stack([fl.int_to_limbs(v) for v in ys], -1)).to(
        torch.int32).to(dev).contiguous()
    kx, ky = fl.fe_mul_chain(x, y, K2)
    torch.cuda.synchronize()
    px, py = fl.fe_mul_chain_plain(x, y, K2)
    canon = lambda t: fl.fe_freeze(t.to(torch.int64))
    err2 = max(int((canon(kx) - canon(px)).abs().max()),
               int((canon(ky) - canon(py)).abs().max()))
    check(err2 == 0, f"K2 differs from its plain version (max abs err {err2})")
    check(torch.equal(kx, px) and torch.equal(ky, py), "K2 raw limbs differ")
    kxh = kx.cpu().numpy()
    for i in rng.choice(B2, 32, replace=False):
        a, b = xs[i], ys[i]
        for _ in range(K2):
            a, b = a * b % fl.P, a
        check(fl.limbs_to_int(kxh[:, i]) == a, f"K2 lane {i} != Python ints")
    ms2 = time_ms(lambda: fl.fe_mul_chain(x, y, K2), reps=20)
    plain2 = time_host_ms(lambda: fl.fe_mul_chain_plain(x, y, K2))
    ops2 = B2 * K2 * sv.PRODUCTS_PER_MUL
    bytes2 = 4 * B2 * fl.NLIMB * 4
    kernels.append(dict(
        name="fe_mul_chain", route="cuda",
        source="firedancer_tpu_torch/csrc/fe_mul_chain.cu",
        replaces="scripts/perf_fe.py:114", launches=None, max_abs_err=err2,
        ms=ms2, plain_ms=plain2,
        bound_ms=max(ops2 / int_ops_per_s, bytes2 / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if ops2 / int_ops_per_s > bytes2 / HBM_BYTES_PER_S else "bytes",
        library_ms=None, matched=True, shape=f"B={B2} k={K2}",
        phase_launches=kbuild.LAUNCHES["fe_mul_chain"]))
    log(f"[K2] fe_mul_chain B={B2} k={K2}: exact; {ms2:.4f} ms,"
        f" {B2 * K2 / ms2 / 1e3:.1f} M fe_mul/s; plain {plain2:.1f} ms")

    # -- 4. K3 sha512_batch ----------------------------------------------------------
    B3, ML3 = 4096, 1232 + 64
    lens = [0, 1, 111, 112, 239, 240, ML3, ML3 - 1, 127, 128, 129]
    lens += [int(v) for v in rng.integers(0, ML3 + 1, size=B3 - len(lens))]
    msgs = [rng.bytes(n) for n in lens]
    m3 = np.zeros((B3, ML3), dtype=np.uint8)
    for i, m in enumerate(msgs):
        m3[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
    m3 = torch.from_numpy(np.ascontiguousarray(m3.T)).to(dev)
    l3 = torch.tensor(lens, dtype=torch.int32, device=dev)
    d3 = fsha.sha512_batch(m3, l3)
    torch.cuda.synchronize()
    p3 = fsha.sha512_batch_plain(m3, l3)
    d3h = d3.cpu().numpy()
    want = np.stack([np.frombuffer(hashlib.sha512(m).digest(), np.uint8) for m in msgs], -1)
    err3 = int(np.abs(d3h.astype(np.int64) - want).max())
    check(err3 == 0, "K3 differs from hashlib")
    check(torch.equal(d3, p3), "K3 differs from its plain version")
    ms3 = time_ms(lambda: fsha.sha512_batch(m3, l3), reps=20)
    plain3 = time_host_ms(lambda: fsha.sha512_batch_plain(m3, l3))
    ops3 = sum((n + 17 + 127) // 128 for n in lens) * SHA512_OPS_PER_BLOCK
    bytes3 = B3 * ML3 + 4 * B3 + 64 * B3
    kernels.append(dict(
        name="sha512_batch", route="cuda",
        source="firedancer_tpu_torch/csrc/sha512_batch.cu",
        replaces="firedancer_tpu/ops/sha512.py:179", launches=None,
        max_abs_err=err3, ms=ms3, plain_ms=plain3,
        bound_ms=max(ops3 / int_ops_per_s, bytes3 / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if ops3 / int_ops_per_s > bytes3 / HBM_BYTES_PER_S else "bytes",
        library_ms=None, matched=True, shape=f"B={B3} max_len={ML3}",
        phase_launches=kbuild.LAUNCHES["sha512_batch"]))
    log(f"[K3] sha512_batch B={B3} max_len={ML3}: equal to hashlib and plain;"
        f" {ms3:.4f} ms; plain {plain3:.1f} ms")

    # -- 5. K1 on the mixed batch ------------------------------------------------------
    B1, ML1 = 1024, 1232
    mb = mixed_batch(B1, ML1, n_real=B1 - 24, seed=5)
    args1 = [torch.from_numpy(a).to(dev) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    mask, cnt = sv.verify_batch(*args1, mb.n_real, max_msg_len=ML1)
    torch.cuda.synchronize()
    pmask, pcnt = sv.verify_batch_plain(*args1, mb.n_real, ML1)
    mask_h = mask.cpu().numpy()
    err1 = int(np.abs(mask_h.astype(np.int64) - pmask.cpu().numpy().astype(np.int64)).max())
    check(err1 == 0, "K1 mask differs from its plain version")
    check((mask_h == mb.labels).all(), "K1 mask differs from ed25519_ref labels: lanes "
          + str(np.nonzero(mask_h != mb.labels)[0][:16].tolist()))
    check(int(cnt) == int(mask_h.sum()) == int(pcnt), "K1 ok-count != sum of mask")
    by_cat = {}
    for c, ok in zip(mb.categories, mask_h):
        by_cat.setdefault(c, [0, 0])[int(ok)] += 1
    log(f"[K1] mixed batch B={B1} max_msg_len={ML1} n_real={mb.n_real}: mask equal to"
        f" plain and labels, ok-count {int(cnt)}; (rejected, accepted) by category {by_cat}")

    # -- 6. K1 timing ---------------------------------------------------------------------
    BT = 16384
    pool = gen_transfer_pool(256, seed=b"smoke")
    mt = np.zeros((BT, ML1), dtype=np.uint8)
    lt = np.zeros((BT,), dtype=np.int32)
    st = np.zeros((BT, 64), dtype=np.uint8)
    pt = np.zeros((BT, 32), dtype=np.uint8)
    from firedancer_tpu_torch.protocol import txn as ft

    trip = []
    for p in pool:
        t = ft.txn_parse(p)
        trip.append((t.message(p), t.signatures(p)[0], t.signers(p)[0]))
    for i in range(BT):
        m, s, k = trip[i % len(trip)]
        mt[i, : len(m)] = np.frombuffer(m, np.uint8)
        lt[i] = len(m)
        st[i] = np.frombuffer(s, np.uint8)
        pt[i] = np.frombuffer(k, np.uint8)
    argst = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (mt.T, lt, st.T, pt.T)]
    tmask, tcnt = sv.verify_batch(*argst, BT, max_msg_len=ML1)
    check(int(tcnt) == BT, f"K1 timing batch: {int(tcnt)} of {BT} honest lanes passed")
    ms1 = time_ms(lambda: sv.verify_batch(*argst, BT, max_msg_len=ML1), reps=3)
    # the pipeline's batch shape, for the device-busy estimate of phase 7
    args1k = [a[..., :B1].contiguous() for a in argst]
    ms1k = time_ms(lambda: sv.verify_batch(*args1k, B1, max_msg_len=ML1), reps=10)
    plain1 = time_host_ms(lambda: sv.verify_batch_plain(*argst, BT, ML1))
    ops1 = BT * sv.MULS_PER_VALID_LANE * sv.PRODUCTS_PER_MUL
    bytes1 = BT * (ML1 + 4 + 64 + 32) + 64 * 16 * 4 * fl.NLIMB * 4 + BT + 4
    kernels.append(dict(
        name="verify_batch", route="cuda", source="firedancer_tpu_torch/csrc/verify.cu",
        replaces="firedancer_tpu/ops/sigverify.py:97", launches=None, max_abs_err=err1,
        ms=ms1, plain_ms=plain1,
        bound_ms=max(ops1 / int_ops_per_s, bytes1 / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if ops1 / int_ops_per_s > bytes1 / HBM_BYTES_PER_S else "bytes",
        library_ms=None, matched=True, shape=f"B={BT} max_msg_len={ML1}",
        sigverify_per_s=BT / ms1 * 1e3, ms_batch1024=ms1k,
        phase_launches=kbuild.LAUNCHES["verify_batch"]))
    log(f"[K1] verify_batch B={BT} max_msg_len={ML1}: {ms1:.3f} ms,"
        f" {BT / ms1 * 1e3:.0f} sigverify/s; plain {plain1:.1f} ms;"
        f" B={B1}: {ms1k:.3f} ms")

    # -- 7. the pipeline (main path) ---------------------------------------------------------
    vs = verify_stream(2100, seed=b"smoke-pipe", n_multisig=8, n_corrupt=6, n_resend=24)
    pipe = build_verify_pipeline(vs.stream, device=dev, batch=B1, max_msg_len=ML1)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    rep = pipe.report()
    e = vs.expect
    check(rep["verify"].get("txn_verified", 0) == e["txn_verified"],
          f"txn_verified {rep['verify'].get('txn_verified')} != {e['txn_verified']}")
    check(rep["verify"].get("verify_fail", 0) == e["verify_fail"],
          f"verify_fail {rep['verify'].get('verify_fail')} != {e['verify_fail']}")
    check(rep["verify"].get("parse_fail", 0) == e["parse_fail"], "parse_fail")
    check(rep["verify"].get("dedup_dup", 0) == e["tile_dedup_dup"], "tile dedup_dup")
    check(rep["dedup"].get("dedup_dup", 0) == e["dedup_dup"],
          f"dedup_dup {rep['dedup'].get('dedup_dup')} != {e['dedup_dup']}")
    check(rep["sink"].get("txn_sunk", 0) == e["sunk"], "sink count")
    check([p for p, _ in pipe.sink.frames] == vs.expect_sunk, "sink frames")
    check(launches.get("verify_batch", 0) > 0, "the pipeline never launched K1")
    check(launches.get("verify_batch", 0) == rep["verify"]["batches"],
          "K1 launches != verify batches")
    txn_s = rep["sink"]["txn_sunk"] / run_s
    # upper estimate: every batch costs a full batch's kernel time
    busy = launches["verify_batch"] * ms1k / (run_s * 1e3)
    log(f"[pipeline] {len(vs.stream)} frames in {run_s:.3f} s: {txn_s:.0f} txn/s sunk;"
        f" launches {launches}; device busy <= {busy:.3f} of the run (K1 event"
        f" time x launches); counters {json.dumps(rep)}")

    for k in kernels:
        check(k["phase_launches"] > 0, f"{k['name']} never launched in its phase")
        k["launches"] = launches.get(k["name"], 0)
    check(ref.verify(b"", ref.sign(b"\x01" * 32, b""), ref.public_key(b"\x01" * 32)),
          "ed25519_ref self-check")
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
