"""The port stands alone and runs on the card by default:

  - no module of firedancer_tpu_torch/, nor chip_smoke.py or
    leader_ab.py, imports jax, jaxlib or the JAX package;
  - the port's host libraries (utils/hostbuild.py) build from its own
    sources in firedancer_tpu_torch/native/, never from the repo's
    native/, into the port's own build folder, and no module names an
    FDTPU_NATIVE_* switch or a PARSER degrade;
  - the entry points, called without device=, raise the "no CUDA device"
    error on a machine without a card instead of running on the CPU;
  - a kernel wrapper given CPU tensors runs its plain version and its
    launch counter stays 0.
"""

import ast
import os

import numpy as np
import pytest
import torch

import firedancer_tpu_torch
from firedancer_tpu_torch import entry as tentry
from firedancer_tpu_torch.flamenco.runtime import SlotExecution, execute_block
from firedancer_tpu_torch.funk import make_funk
from firedancer_tpu_torch.models import leader_topo as tltopo
from firedancer_tpu_torch.models import workload as tw
from firedancer_tpu_torch.models.leader import (
    build_leader_pipeline,
    build_sharded_leader_pipeline,
    build_sharded_verify_pipeline,
    build_verify_pipeline,
)
from firedancer_tpu_torch.ops import blake3 as tb3
from firedancer_tpu_torch.ops import bmtree as tbm
from firedancer_tpu_torch.ops import chacha20 as tcc
from firedancer_tpu_torch.ops import gf256 as tg2
from firedancer_tpu_torch.ops import keccak256 as tkk
from firedancer_tpu_torch.ops import limbs as tl
from firedancer_tpu_torch.ops import aes as taes
from firedancer_tpu_torch.ops import lthash as tlt
from firedancer_tpu_torch.ops import probe as tprobe
from firedancer_tpu_torch.ops import reedsol as trs
from firedancer_tpu_torch.ops import sha256 as tsha256
from firedancer_tpu_torch.ops import sha512 as tsha
from firedancer_tpu_torch.ops import sigverify as tsv
from firedancer_tpu_torch.parallel.mesh import make_mesh
from firedancer_tpu_torch.parallel.serve import ServeConfig, ServePlane
from firedancer_tpu_torch.runtime import poh as tpoh
from firedancer_tpu_torch.runtime.bank import BankCtx, default_bank_ctx
from firedancer_tpu_torch.runtime import net as tnet
from firedancer_tpu_torch.runtime import net_native as tnn
from firedancer_tpu_torch.runtime import topo as ttopo
from firedancer_tpu_torch.runtime import shred_native as tsn
from firedancer_tpu_torch.runtime import verify_native as tvn
from firedancer_tpu_torch.runtime.fec_resolver import FecResolver
from firedancer_tpu_torch.runtime.shred_stage import ShredStage
from firedancer_tpu_torch.runtime.shredder import Shredder
from firedancer_tpu_torch.runtime.slot_clock import SlotClockCfg
from firedancer_tpu_torch.runtime.store import StoreStage
from firedancer_tpu_torch.runtime.verify import VerifyStage
from firedancer_tpu_torch.utils import hostbuild, kbuild
from firedancer_tpu_torch.utils.platform import resolve_device

PKG = os.path.dirname(os.path.abspath(firedancer_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "firedancer_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "leader_ab.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_or_jax_package_imports():
    srcs = _sources()
    assert os.path.exists(srcs[0]) and len(srcs) > 15
    bad = []
    for path in srcs:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), mod))
    assert bad == []


def _host_libraries() -> set[str]:
    """The names every port module passes to hostbuild.load."""
    names = set()
    for path in _sources():
        for node in ast.walk(ast.parse(open(path).read(), filename=path)):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "load" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "hostbuild"):
                assert isinstance(node.args[0], ast.Constant), path
                names.add(node.args[0].value)
    return names


def test_host_libraries_build_from_the_ports_own_sources():
    names = _host_libraries()
    assert names == {"fd_pack", "fd_tcache", "fd_exec_native", "fd_txn_parse", "fd_ring",
                     "fd_bank", "fd_shred", "fd_verify", "fd_funk", "fd_net"}
    native = os.path.join(PKG, "native")
    assert hostbuild.NATIVE_DIR == native
    # the sources and the one header the sweep clients include
    assert sorted(os.listdir(native)) == sorted([f"{n}.cpp" for n in names] + ["fd_metrics.h"])
    for n in names:
        assert hostbuild.source(n) == os.path.join(native, f"{n}.cpp")
        assert os.path.dirname(os.path.dirname(hostbuild.so_path(n))) == \
            os.path.join(ROOT, "build", "torch_native")
    # no port module but utils/hostbuild.py names a native/ folder
    for path in _sources()[1:]:
        for node in ast.walk(ast.parse(open(path).read(), filename=path)):
            if isinstance(node, ast.Constant) and node.value == "native":
                assert path == os.path.join(PKG, "utils", "hostbuild.py"), path
    hostbuild.load("fd_tcache")
    assert all(p.startswith(hostbuild.BUILD_ROOT) for p in hostbuild._LIBS)


def test_no_switch_or_degrade_picks_a_python_lane():
    """No port module reads the JAX package's lane switches or keeps a
    parser degrade: a native lane is picked by an argument, and a failed
    build raises."""
    bad = []
    for path in _sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and node.value.startswith("FDTPU_NATIVE"):
                bad.append((os.path.relpath(path, ROOT), node.value))
            if isinstance(node, ast.Name) and node.id == "PARSER":
                bad.append((os.path.relpath(path, ROOT), node.id))
    assert bad == []


def test_native_lanes_have_no_switch_probe_or_degrade():
    """The native shredder, the verify sweep client, the net client, the
    ingress stages and AES are picked by arguments only: no module reads
    the environment, nor keeps the JAX package's available() probe or its
    NativeUnavailable degrade."""
    for mod in (tsn, tvn, tnn, tnet, taes):
        src = open(mod.__file__).read()
        names = {n.id for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Name)}
        names |= {n.attr for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Attribute)}
        names |= {n.name for n in ast.walk(ast.parse(src))
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        assert not names & {"environ", "getenv", "available", "enabled", "NativeUnavailable",
                            "ENV_SWITCH"}, mod.__name__
        assert "FDTPU_" not in src, mod.__name__


def test_native_sources_read_no_environment():
    """No native source of the port calls getenv (the JAX package's
    fd_net.cpp reads FDTPU_NATIVE_NET_NOSIMD), ops/aes.py has no getenv
    and no lazy switch, and runtime/net*.py reads no os.environ."""
    native = os.path.join(PKG, "native")
    srcs = [os.path.join(native, f) for f in os.listdir(native)]
    assert os.path.join(native, "fd_net.cpp") in srcs
    for path in srcs + [taes.__file__]:
        assert "getenv" not in open(path).read(), path
    assert "_native()" not in open(taes.__file__).read()
    for mod in (tnet, tnn, taes):
        tree = ast.parse(open(mod.__file__).read())
        attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not attrs & {"environ", "getenv"}, mod.__name__


def test_native_shredder_on_a_missing_card_raises_and_takes_no_cpu_lane(monkeypatch):
    """Asked for the card (by default or by name) on a host without one,
    the native shredder raises from utils/platform.py before any parity
    call is chosen: the CPU trampoline is never built."""
    _no_card()

    def cpu_lane(self):
        raise AssertionError("the CPU parity trampoline was taken")

    monkeypatch.setattr(tsn._CpuParity, "__init__", cpu_lane)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device") as e:
            tsn.NativeShredder(secret=bytes(32), device=dev)
        assert e.traceback[-1].path.name == "platform.py"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")


@pytest.mark.parametrize("call", [
    "resolve_device", "pipeline", "verify_stage", "entry", "example_batch",
    "make_mesh", "serve_plane", "sharded_pipeline", "verify_segments",
    "leader_step", "reedsol_encode", "bank_alloc", "comb_fill", "comb_pipeline",
    "split_pipeline", "autotune_pipeline", "leader_pipeline",
    "sharded_leader_pipeline", "bank_ctx", "default_bank_ctx", "slot_execution",
    "execute_block", "shredder", "fec_resolver", "store", "lthash_combine",
    "leader_block", "bmtree_hash_leaves_batch", "bmtree_layers_batch",
    "bmtree_root_batch", "clock_leader_pipeline", "clock_fused_leader_pipeline",
    "python_pack_leader_pipeline", "python_pack_sharded_leader_pipeline", "zk_bank_ctx",
    "native_pack_leader_block", "python_exec_bank_ctx", "python_exec_default_bank_ctx",
    "python_exec_nonce_bank_ctx", "native_shredder", "native_shred_stage",
    "udp_ingress_leader_pipeline", "leader_topology", "leader_topology_fused",
    "topology_launch"])
def test_entry_points_default_to_the_card(call):
    _no_card()
    h = bytes(32)
    fns = {
        "resolve_device": lambda: resolve_device(),
        "pipeline": lambda: build_verify_pipeline([b"x"]),
        "verify_stage": lambda: VerifyStage("v"),
        "entry": lambda: tentry.entry(),
        "example_batch": lambda: tentry.example_batch(2),
        "make_mesh": lambda: make_mesh(1),
        "serve_plane": lambda: ServePlane(ServeConfig(n_devices=1)),
        "sharded_pipeline": lambda: build_sharded_verify_pipeline([b"x"]),
        "verify_segments": lambda: tpoh.verify_segments([h], 1, [h]),
        "leader_step": lambda: tentry.leader_step(),
        "reedsol_encode": lambda: trs.encode(np.zeros((2, 4), np.uint8), 1),
        "bank_alloc": lambda: tsv.bank_alloc(4),
        "comb_fill": lambda: tsv.comb_fill(np.zeros((32, 2), np.uint8)),
        "comb_pipeline": lambda: build_verify_pipeline([b"x"], comb_slots=4),
        "split_pipeline": lambda: build_verify_pipeline([b"x"], kernel="split"),
        "autotune_pipeline": lambda: build_verify_pipeline([b"x"], autotune_after=4),
        "leader_pipeline": lambda: build_leader_pipeline([b"x"]),
        "sharded_leader_pipeline": lambda: build_sharded_leader_pipeline([b"x"]),
        "bank_ctx": lambda: BankCtx(),
        "default_bank_ctx": lambda: default_bank_ctx(),
        "slot_execution": lambda: SlotExecution(make_funk(), slot=1),
        "execute_block": lambda: execute_block(make_funk(), slot=1, txns=[]),
        "shredder": lambda: Shredder(signer=lambda r: bytes(64)),
        "fec_resolver": lambda: FecResolver(),
        "store": lambda: StoreStage("store"),
        "lthash_combine": lambda: tlt.combine_device(np.zeros((1, 1024), np.uint16)),
        "leader_block": lambda: tentry.leader_block([b"x"]),
        "bmtree_hash_leaves_batch": lambda: tbm.hash_leaves_batch(np.zeros((8, 2), np.uint8)),
        "bmtree_layers_batch": lambda: tbm.layers_batch(np.zeros((3, 20, 2), np.uint8)),
        "bmtree_root_batch": lambda: tbm.root_batch(np.zeros((3, 20, 2), np.uint8)),
        "clock_leader_pipeline": lambda: build_leader_pipeline(
            [b"x"], slot_clock=SlotClockCfg(slot_ms=400.0, ticks_per_slot=64, n_slots=2)),
        "clock_fused_leader_pipeline": lambda: build_leader_pipeline(
            [b"x"], slot_clock=SlotClockCfg(slot_ms=400.0, ticks_per_slot=64, n_slots=2),
            fuse_poh_shred=True),
        "python_pack_leader_pipeline": lambda: build_leader_pipeline([b"x"], native_pack=False),
        "python_pack_sharded_leader_pipeline": lambda: build_sharded_leader_pipeline(
            [b"x"], native_pack=False),
        "zk_bank_ctx": lambda: tw.zk_bank_ctx(tw.ZkStream([], {}, set(), {}, {}, {}, 1, b"b")),
        "native_pack_leader_block": lambda: tentry.leader_block([b"x"], native_pack=False),
        "python_exec_bank_ctx": lambda: BankCtx(native_exec=False),
        "python_exec_default_bank_ctx": lambda: default_bank_ctx(native_exec=False),
        "python_exec_nonce_bank_ctx": lambda: tw.nonce_bank_ctx(1, native_exec=False),
        "native_shredder": lambda: tsn.NativeShredder(secret=h),
        "native_shred_stage": lambda: ShredStage("shred", signer=None, secret=h),
        "udp_ingress_leader_pipeline": lambda: build_leader_pipeline(udp_ingress=True),
        "leader_topology": lambda: tltopo.build_leader_topology(),
        "leader_topology_fused": lambda: tltopo.build_leader_topology_fused(),
        "topology_launch": lambda: ttopo.launch(ttopo.Topology()),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fns[call]()
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_on_cpu_tensors_run_plain_and_never_count():
    kbuild.reset_launches()
    x = torch.from_numpy(np.stack([tl.int_to_limbs(v) for v in (3, 5)], -1))
    xo, _ = tl.fe_mul_chain(x.to(torch.int32), x.to(torch.int32), 2)
    assert tl.limbs_to_int(xo[:, 0].numpy()) == pow(3, 3, tl.P)
    d = tsha.sha512_batch(torch.zeros((8, 2), dtype=torch.uint8),
                          torch.tensor([0, 3], dtype=torch.int32))
    assert d.shape == (64, 2)
    fn, args = tentry.entry(device="cpu")
    assert fn(*args).all()
    mask, cnt = tsv.verify_batch(*args, 5, max_msg_len=tentry.MAX_MSG_LEN)
    assert mask.tolist() == [True] * 5 + [False] * 3 and int(cnt) == 5
    # K14-K18 and the bmtree layers on CPU tensors
    m, ln = torch.zeros((70, 2), dtype=torch.uint8), torch.tensor([0, 70], dtype=torch.int32)
    assert torch.equal(tsha256.sha256_msg(m, ln), tsha256.sha256_msg_plain(m, ln, 70))
    st = torch.zeros((32, 2), dtype=torch.uint8)
    assert torch.equal(tsha256.sha256_mix32(st, st), tsha256.sha256_mix32_plain(st, st))
    assert torch.equal(tb3.blake3_msg(m, ln), tb3.blake3_msg_plain(m, ln, 70))
    assert torch.equal(tkk.keccak256_msg(m, ln), tkk.keccak256_msg_plain(m, ln, 70))
    idx = torch.tensor([0, -1], dtype=torch.int32)
    assert torch.equal(tcc.chacha20_keystream(st, idx), tcc.chacha20_keystream_plain(st, idx, None))
    leaves = torch.zeros((3, 20, 2), dtype=torch.uint8)
    assert tbm.root_batch(leaves).device.type == "cpu"
    assert tbm.hash_leaves_batch(m).shape == (20, 2)
    assert sum(kbuild.LAUNCHES.values()) == 0


def test_plane_wrappers_on_cpu_tensors_run_plain_and_never_count():
    kbuild.reset_launches()
    st = torch.zeros((32, 2), dtype=torch.uint8)
    assert torch.equal(tsha256.sha256_iter32(st, 1), tsha256.sha256_iter32_plain(st, 1))
    mat = torch.ones((1, 2, 3), dtype=torch.uint8)
    data = torch.arange(24, dtype=torch.uint8).reshape(2, 3, 4)
    assert torch.equal(tg2.gf_apply_batch(mat, data), tg2.gf_apply_batch_plain(mat, data))
    assert torch.equal(tg2.gf_apply_batch(mat, data)[:, 0], data[:, 0] ^ data[:, 1] ^ data[:, 2])
    x = torch.full((8, 128), 2**31 - 1, dtype=torch.int32)
    assert (tprobe.probe_add(x, torch.ones_like(x)) == -2**31).all()
    rows = torch.full((3, 1024), -1, dtype=torch.int16)  # 0xFFFF lanes
    assert (tlt.combine_device(rows, torch.tensor([1, 1, -1], dtype=torch.int8)) == 0xFFFF).all()
    a = torch.full((20, 4), 100, dtype=torch.int32)
    conv = tprobe.probe_conv(a, 2 * a)
    assert conv.shape == (39, 4) and conv[:, 0].tolist() == \
        [20000 * min(k + 1, 39 - k) for k in range(39)]
    assert sum(kbuild.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        tprobe.probe_conv(a[:19].contiguous(), a[:19].contiguous())
    with pytest.raises(ValueError):
        tprobe.probe_add(x, torch.ones((8, 128), dtype=torch.int64))


def test_wrappers_refuse_bad_inputs():
    fn, args = tentry.entry(device="cpu")
    msg, ln, sig, pk = args
    with pytest.raises(ValueError):
        tsv.verify_batch(msg.to(torch.int32), ln, sig, pk, 8,
                         max_msg_len=tentry.MAX_MSG_LEN)
    with pytest.raises(ValueError):
        tsv.verify_batch(msg, ln, sig, pk, 8, max_msg_len=64)
    # the split rung runs (its plain phases on CPU tensors) and counts 4
    kbuild.reset_launches()
    mask, n_ok = tsv.verify_dispatch("split", msg, ln, sig, pk, 8,
                                     max_msg_len=tentry.MAX_MSG_LEN)
    assert n_ok is None and mask.tolist() == [True] * 8
    assert sum(kbuild.LAUNCHES.values()) == 0
    assert tsv.kernel_dispatch_count("split") == 4
    assert [tsv.kernel_dispatch_count(k) for k in tsv.KERNEL_LADDER] == [1, 1, 4]
    with pytest.raises(ValueError):
        tsv.verify_dispatch("warp", msg, ln, sig, pk, 8, max_msg_len=tentry.MAX_MSG_LEN)
    with pytest.raises(KeyError):
        tsv.kernel_dispatch_count("warp")
    # K14-K18: wrong dtype or shape, lengths out of range, BLAKE3 past a chunk
    m, ln = torch.zeros((64, 2), dtype=torch.uint8), torch.tensor([0, 64], dtype=torch.int32)
    for hash_fn in (tsha256.sha256_msg, tb3.blake3_msg, tkk.keccak256_msg):
        for bad in ((m.to(torch.int32), ln), (m, ln.to(torch.int64)), (m, ln[:1]),
                    (m, torch.tensor([0, 65], dtype=torch.int32)),
                    (m, torch.tensor([-1, 0], dtype=torch.int32)), (m, ln, 63)):
            with pytest.raises(ValueError):
                hash_fn(*bad)
    with pytest.raises(ValueError, match="1024"):
        tb3.blake3_msg(torch.zeros((1025, 2), dtype=torch.uint8), ln)
    st = torch.zeros((32, 2), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tsha256.sha256_mix32(st, st[:31].contiguous())
    with pytest.raises(ValueError):
        tcc.chacha20_keystream(st, torch.zeros(2, dtype=torch.int16))
    with pytest.raises(ValueError):
        tbm.layers_batch(torch.zeros((2, 20, 2), dtype=torch.int32))


def test_the_scan_covers_the_operator_surface_and_chaos():
    """The import scan above walks every module of the port: the chaos
    harness, protocol/http.py and the monitor's modules among them, which
    also write only inside the checkout's build/ and read no environment."""
    from firedancer_tpu_torch.runtime import monitor as tmon

    srcs = {os.path.relpath(p, PKG) for p in _sources()[1:]}
    for mod in ("chaos/__init__.py", "chaos/faults.py", "chaos/invariants.py",
                "chaos/scenario.py", "protocol/http.py", "runtime/monitor.py",
                "runtime/slot_report.py", "runtime/slo.py", "tango/lossy.py"):
        assert mod in srcs, mod
        tree = ast.parse(open(os.path.join(PKG, mod)).read())
        attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not attrs & {"environ", "getenv"}, mod
    assert tmon.RUN_DIR == os.path.join(ROOT, "build", "torch_run")
