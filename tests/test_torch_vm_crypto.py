"""The VM's crypto in the port against the JAX package, exactly: murmur3
and the syscall ids (ops/smallhash.py), ristretto255 (ops/ristretto.py),
Poseidon over BN254 (ops/poseidon.py, with the port's own copy of the
parameter file), BN254 (ops/bn254.py), and the syscalls over them and the
rest of tests/test_vm_syscalls2.py's: each case runs on both packages'
VMs and compares r0, cu_used and the input region's bytes.  The mirrored
cases keep their JAX tests' known answers (RFC 9496's multiples of the
base, the light-poseidon KAT, EIP-196/197 group laws).  Pairings are pure
Python (about a second for two pairs on a CPU core), so only a few run."""

import hashlib
import os

import numpy as np
import pytest

import firedancer_tpu
import firedancer_tpu_torch
from firedancer_tpu.flamenco import executor as jex
from firedancer_tpu.flamenco import runtime as jrt
from firedancer_tpu.flamenco import vm as jvm
from firedancer_tpu.ops import bn254 as jbn
from firedancer_tpu.ops import poseidon as jpos
from firedancer_tpu.ops import ristretto as jri
from firedancer_tpu.ops import smallhash as jsh
from firedancer_tpu.protocol import sbpf as jsbpf
from firedancer_tpu_torch.flamenco import executor as tex
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.flamenco import vm as tvm
from firedancer_tpu_torch.models.workload import build_elf, ins
from firedancer_tpu_torch.ops import bn254 as tbn
from firedancer_tpu_torch.ops import poseidon as tpos
from firedancer_tpu_torch.ops import ristretto as tri
from firedancer_tpu_torch.ops import smallhash as tsh
from firedancer_tpu_torch.ops.blake3 import blake3_host
from firedancer_tpu_torch.ops.ref import ed25519_ref as ted
from firedancer_tpu_torch.protocol import sbpf as tsbpf

INP = tvm.MM_INPUT
PKGS = ((jvm, jsbpf, jrt), (tvm, tsbpf, trt))


# -- smallhash ---------------------------------------------------------------------------------

SYSCALL_IDS = {"abort": 0xB6FC1A11, "sol_panic_": 0x686093BB, "sol_log_": 0x207559BD,
               "sol_sha256": 0x11F49D86, "sol_keccak256": 0xD7793ABB,
               "sol_secp256k1_recover": 0x17E40350, "sol_blake3": 0x174C5122}


def test_murmur3_syscall_ids():
    for name, want in SYSCALL_IDS.items():
        assert tsh.syscall_id(name) == jsh.syscall_id(name) == want, name
    assert tvm.SYSCALL_SOL_SHA256 == tsh.syscall_id("sol_sha256")
    assert tvm.SYSCALL_SOL_LOG == tsh.syscall_id("sol_log_")


@pytest.mark.parametrize("n", range(0, 40, 3))
def test_murmur3_matches_jax(n):
    rng = np.random.default_rng(n)
    for seed in (0, 1, 0xFFFFFFFF, int(rng.integers(0, 2**32))):
        data = rng.bytes(n)
        assert tsh.murmur3_32(data, seed) == jsh.murmur3_32(data, seed)
    assert len({tsh.murmur3_32(b"x" * k) for k in range(9)}) == 9


# -- ristretto and poseidon --------------------------------------------------------------------

def test_ristretto_rfc9496_multiples_and_parity():
    """RFC 9496's encodings of B, 2B and 3B; encode and decode agree with
    JAX on seeded multiples and on random (mostly invalid) strings."""
    two_b = bytes.fromhex("6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919")
    three_b = bytes.fromhex("94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259")
    assert tri.BASE_BYTES == jri.BASE_BYTES
    assert tri.encode(tri.mul(2, tri.BASE_POINT)) == two_b
    assert tri.encode(tri.multiscalar_mul([1, 2], [tri.BASE_POINT] * 2)) == three_b
    rng = np.random.default_rng(9496)
    for _ in range(24):
        s = int(rng.integers(1, 2**62))
        enc = tri.encode(tri.mul(s, tri.BASE_POINT))
        assert enc == jri.encode(jri.mul(s, jri.BASE_POINT))
        assert tri.encode(tri.decode(enc)) == enc
        junk = rng.bytes(32)
        assert tri.validate(junk) == jri.validate(junk)
        u = rng.bytes(64)
        assert tri.encode(tri.from_uniform_bytes(u)) == jri.encode(jri.from_uniform_bytes(u))


def test_poseidon_parameter_file_is_the_ports_own():
    tdata = os.path.join(os.path.dirname(firedancer_tpu_torch.__file__), "ops", "data",
                         "poseidon_bn254.bin.gz")
    jdata = os.path.join(os.path.dirname(firedancer_tpu.__file__), "ops", "data",
                         "poseidon_bn254.bin.gz")
    assert os.path.abspath(tpos._DATA) == os.path.abspath(tdata)
    with open(tdata, "rb") as f, open(jdata, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("n_inputs", [1, 2, 3, 5, 12])
def test_poseidon_matches_jax(n_inputs):
    rng = np.random.default_rng(n_inputs)
    for big in (True, False):
        ins_ = [rng.bytes(int(rng.integers(1, 33))) for _ in range(n_inputs)]
        ins_ = [b if int.from_bytes(b, "big" if big else "little") < tpos.P else b[:16]
                for b in ins_]
        assert tpos.poseidon_hash(ins_, big_endian=big) == jpos.poseidon_hash(ins_, big_endian=big)
    with pytest.raises(tpos.PoseidonError):
        tpos.poseidon_hash([b"\xff" * 32], big_endian=True)  # not canonical
    with pytest.raises(jpos.PoseidonError):
        jpos.poseidon_hash([b"\xff" * 32], big_endian=True)


# -- BN254: tests/test_bn254.py on both packages -----------------------------------------------

@pytest.mark.parametrize("bn", [jbn, tbn], ids=["jax", "torch"])
def test_bn254_g1_group_law(bn):
    g = bn.G1_GEN
    d = bn.g1_add(g, g)
    s = 3 * pow(4, bn.P - 2, bn.P) % bn.P
    x3 = (s * s - 2) % bn.P
    assert d == (x3, (s * (1 - x3) - 2) % bn.P)
    assert bn.g1_mul(g, 2) == d and bn.g1_add(d, (g[0], bn.P - g[1])) == g
    assert bn.g1_mul(g, 3) == bn.g1_add(d, g)
    assert bn.g1_add(g, None) == g and bn.g1_add(None, None) is None
    assert bn.g1_mul(g, 0) is None and bn.g1_mul(g, bn.R) is None
    with pytest.raises(bn.Bn254Error, match="not on G1"):
        bn.g1_check((1, 3))
    with pytest.raises(bn.Bn254Error, match="out of range"):
        bn.g1_check((bn.P, 2))
    assert bn.g2_embed(bn.G2_GEN) is not None
    with pytest.raises(bn.Bn254Error, match="not on twisted G2"):
        bn.g2_embed(((1, 2), (3, 4)))


def test_bn254_pairing_inverse_pair_and_bilinearity():
    neg_g1 = (1, tbn.P - 2)
    assert tbn.pairing_check([(tbn.G1_GEN, tbn.G2_GEN), (neg_g1, tbn.G2_GEN)])
    assert not tbn.pairing_check([(tbn.G1_GEN, tbn.G2_GEN)])
    assert tbn.pairing_check([])
    q = tbn.g2_embed(tbn.G2_GEN)
    aq = tbn._ec_mul(q, 7)
    ag = tbn.g1_mul(tbn.G1_GEN, 7)
    p_ag = (tbn.f12_from_fp(ag[0]), tbn.f12_from_fp(ag[1]))
    p_ng = (tbn.f12_from_fp(neg_g1[0]), tbn.f12_from_fp(neg_g1[1]))
    acc = tbn.f12_mul(tbn.miller_loop(q, p_ag), tbn.miller_loop(aq, p_ng))
    assert tbn.f12_pow(acc, tbn._FINAL_EXP) == tbn.f12_one()
    assert jbn.miller_loop(jbn.g2_embed(jbn.G2_GEN), p_ag) == tbn.miller_loop(q, p_ag)


def _g2_bytes(bn) -> bytes:
    return b"".join(v.to_bytes(32, "big") for v in (bn.G2_GEN[0][0], bn.G2_GEN[0][1],
                                                     bn.G2_GEN[1][0], bn.G2_GEN[1][1]))


def test_bn254_wire_encodings_match_jax():
    g = tbn.G1_GEN
    enc = tbn.g1_encode(g)
    assert enc == jbn.g1_encode(g) and tbn.g1_decode(enc) == g
    assert tbn.g1_decode(bytes(64)) is None and tbn.g1_encode(None) == bytes(64)
    rng = np.random.default_rng(254)
    for _ in range(8):
        k = int(rng.integers(1, 2**62))
        a, b = tbn.g1_encode(tbn.g1_mul(g, k)), tbn.g1_encode(tbn.g1_mul(g, k + 3))
        assert tbn.alt_bn128_addition(a + b) == jbn.alt_bn128_addition(a + b)
        m = a + k.to_bytes(32, "big")
        assert tbn.alt_bn128_multiplication(m) == jbn.alt_bn128_multiplication(m)
        assert tbn.g1_compress(a) == jbn.g1_compress(a)
        assert tbn.g1_decompress(tbn.g1_compress(a)) == a
    g2 = _g2_bytes(tbn)
    assert tbn.g2_compress(g2) == jbn.g2_compress(g2)
    assert tbn.g2_decompress(tbn.g2_compress(g2)) == g2
    neg = tbn.g1_encode((1, tbn.P - 2))
    assert tbn.alt_bn128_pairing(enc + g2 + neg + g2) == (1).to_bytes(32, "big")
    with pytest.raises(tbn.Bn254Error, match="multiple of 192"):
        tbn.alt_bn128_pairing(b"\x00" * 100)


# -- the syscalls: tests/test_vm_syscalls2.py and the bn254 bridge on both VMs ----------------

def mkvm(vm, sbpf, input_data=b"\x00" * 4096, budget=2_000_000):
    m = vm.Vm(sbpf.load(build_elf(ins(0x95))), input_data=input_data, budget=budget)
    vm.register_default_syscalls(m)
    return m


def call(m, sid, *args):
    return m.syscalls[sid](m, *(list(args) + [0] * (5 - len(args))))


def put(m, off, data):
    m._write_span(INP + off, data)
    return INP + off


def get(m, off, n):
    return m.mem_read_bytes(INP + off, n)


def _blake3(vm, m):
    data_addr = put(m, 0, b"blake3 syscall")
    put(m, 100, data_addr.to_bytes(8, "little") + (14).to_bytes(8, "little"))
    return [call(m, vm.SYSCALL_SOL_BLAKE3, INP + 100, 1, INP + 200), get(m, 200, 32)]


def _poseidon(vm, m):
    data_addr = put(m, 0, bytes([1]) * 32)
    put(m, 100, data_addr.to_bytes(8, "little") + (32).to_bytes(8, "little"))
    return [call(m, vm.SYSCALL_SOL_POSEIDON, 0, 1, INP + 100, 1, INP + 200), get(m, 200, 32),
            call(m, vm.SYSCALL_SOL_POSEIDON, 0, 0, INP + 100, 1, INP + 300), get(m, 300, 32),
            call(m, vm.SYSCALL_SOL_POSEIDON, 9, 1, INP + 100, 1, INP + 200),
            call(m, vm.SYSCALL_SOL_POSEIDON, 0, 1, INP + 100, 13, INP + 200)]


def _big_mod_exp(vm, m):
    base, exp, mod = (put(m, 16 * i, v.to_bytes(8, "big")) for i, v in enumerate((7, 5, 13)))
    params = put(m, 64, b"".join(v.to_bytes(8, "little") for v in (base, 8, exp, 8, mod, 8)))
    out = [call(m, vm.SYSCALL_SOL_BIG_MOD_EXP, params, INP + 300), get(m, 300, 8)]
    put(m, 32, bytes(8))
    return out + [call(m, vm.SYSCALL_SOL_BIG_MOD_EXP, params, INP + 300)]


def _bn128_compression(vm, m):
    bn = tbn
    enc = bn.g1_encode(bn.g1_mul(bn.G1_GEN, 9))
    put(m, 0, enc)
    put(m, 400, _g2_bytes(bn))
    out = [call(m, vm.SYSCALL_SOL_ALT_BN128_COMPRESSION, 0, INP, 64, INP + 100),
           get(m, 100, 32),
           call(m, vm.SYSCALL_SOL_ALT_BN128_COMPRESSION, 1, INP + 100, 32, INP + 200),
           get(m, 200, 64),
           call(m, vm.SYSCALL_SOL_ALT_BN128_COMPRESSION, 2, INP + 400, 128, INP + 600),
           get(m, 600, 64),
           call(m, vm.SYSCALL_SOL_ALT_BN128_COMPRESSION, 3, INP + 600, 64, INP + 700),
           get(m, 700, 128),
           call(m, vm.SYSCALL_SOL_ALT_BN128_COMPRESSION, 7, INP, 64, INP + 100)]
    assert out[3] == enc and out[7] == _g2_bytes(bn)
    return out


def _bn128_group_op(vm, m):
    g = tbn.g1_encode(tbn.G1_GEN)
    put(m, 0, g + g)
    put(m, 200, g + (5).to_bytes(32, "big"))
    return [call(m, vm.SYSCALL_SOL_ALT_BN128, vm.ALT_BN128_ADD, INP, 128, INP + 128),
            get(m, 128, 64),
            call(m, vm.SYSCALL_SOL_ALT_BN128, vm.ALT_BN128_MUL, INP + 200, 96, INP + 300),
            get(m, 300, 64),
            call(m, vm.SYSCALL_SOL_ALT_BN128, 1, INP, 128, INP + 128),
            call(m, vm.SYSCALL_SOL_ALT_BN128, vm.ALT_BN128_ADD, INP, 17, INP + 128)]


def _bn128_pairing(vm, m):
    g2 = _g2_bytes(tbn)
    put(m, 0, tbn.g1_encode(tbn.G1_GEN) + g2 + tbn.g1_encode((1, tbn.P - 2)) + g2)
    return [call(m, vm.SYSCALL_SOL_ALT_BN128, vm.ALT_BN128_PAIRING, INP, 384, INP + 500),
            get(m, 500, 32)]


def _curve_validate(vm, m):
    out = []
    for curve, data in ((vm.CURVE25519_EDWARDS, ted.point_compress(ted.BASE)),
                        (vm.CURVE25519_RISTRETTO, tri.BASE_BYTES),
                        (vm.CURVE25519_RISTRETTO, (2**255 - 20).to_bytes(32, "little")),
                        (vm.CURVE25519_EDWARDS, (2**255 - 1).to_bytes(32, "little")),
                        (5, tri.BASE_BYTES)):
        put(m, 0, data)
        out.append(call(m, vm.SYSCALL_SOL_CURVE_VALIDATE_POINT, curve, INP))
    return out


def _curve_group_ops(vm, m):
    out = []
    for curve, base in ((vm.CURVE25519_RISTRETTO, tri.BASE_BYTES),
                        (vm.CURVE25519_EDWARDS, ted.point_compress(ted.BASE))):
        put(m, 0, base)
        put(m, 32, base)
        out += [call(m, vm.SYSCALL_SOL_CURVE_GROUP_OP, curve, vm.CURVE_OP_ADD, INP, INP + 32,
                     INP + 100), get(m, 100, 32)]
        put(m, 200, (2).to_bytes(32, "little"))
        out += [call(m, vm.SYSCALL_SOL_CURVE_GROUP_OP, curve, vm.CURVE_OP_MUL, INP + 200, INP,
                     INP + 300), get(m, 300, 32)]
        put(m, 400, get(m, 100, 32))
        out += [call(m, vm.SYSCALL_SOL_CURVE_GROUP_OP, curve, vm.CURVE_OP_SUB, INP + 400, INP,
                     INP + 500), get(m, 500, 32)]
        put(m, 600, ted.L.to_bytes(32, "little"))
        out += [call(m, vm.SYSCALL_SOL_CURVE_GROUP_OP, curve, vm.CURVE_OP_MUL, INP + 600, INP,
                     INP + 300)]
    assert out[1] == out[3] and out[5] == tri.BASE_BYTES
    assert out[1] == bytes.fromhex(
        "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919")
    return out


def _curve_msm(vm, m):
    out = []
    for curve, base in ((vm.CURVE25519_RISTRETTO, tri.BASE_BYTES),
                        (vm.CURVE25519_EDWARDS, ted.point_compress(ted.BASE))):
        put(m, 0, (1).to_bytes(32, "little") + (2).to_bytes(32, "little"))
        put(m, 100, base + base)
        out += [call(m, vm.SYSCALL_SOL_CURVE_MULTISCALAR_MUL, curve, INP, INP + 100, 2,
                     INP + 200), get(m, 200, 32)]
        put(m, 0, ted.L.to_bytes(32, "little") + (2).to_bytes(32, "little"))
        out += [call(m, vm.SYSCALL_SOL_CURVE_MULTISCALAR_MUL, curve, INP, INP + 100, 2,
                     INP + 200),
                call(m, vm.SYSCALL_SOL_CURVE_MULTISCALAR_MUL, curve, INP, INP + 100, 0,
                     INP + 200)]
    assert out[1] == bytes.fromhex(
        "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259")
    return out


def _introspection(vm, m):
    m.stack_height = 3
    return [call(m, vm.SYSCALL_SOL_GET_STACK_HEIGHT), call(m, vm.SYSCALL_SOL_REMAINING_CU)]


def _sibling(vm, m):
    m.stack_height = 1
    m.instr_trace = [(1, b"P" * 32, [(b"A" * 32, True, False)], b"\x01\x02"),
                     (2, b"X" * 32, [], b"inner"),
                     (1, b"Q" * 32, [(b"B" * 32, False, True)], b"\x09")]
    out = []
    for index, lens in ((0, (1, 1)), (1, (16, 8)), (1, (2, 1)), (2, (0, 0))):
        put(m, 0, lens[0].to_bytes(8, "little") + lens[1].to_bytes(8, "little"))
        out += [call(m, vm.SYSCALL_SOL_GET_SIBLING_INSTR, index, INP, INP + 100, INP + 200,
                     INP + 300), get(m, 0, 16), get(m, 100, 32), get(m, 200, 2), get(m, 300, 34)]
    assert out[0] == 1 and out[2] == b"Q" * 32 and out[-5] == 0
    m.stack_height = 2
    m.instr_trace = [(1, b"A" * 32, [], b""), (2, b"X" * 32, [], b"childA"),
                     (1, b"B" * 32, [], b"")]
    put(m, 0, bytes(16))
    out.append(call(m, vm.SYSCALL_SOL_GET_SIBLING_INSTR, 0, INP, INP + 100, INP + 200, INP + 300))
    assert out[-1] == 0
    return out


def _sysvar_getters(vm, m):
    m.sysvars = (trt if vm is tvm else jrt).default_sysvars(7)
    out = []
    for k, sid in enumerate((vm.SYSCALL_SOL_GET_FEES, vm.SYSCALL_SOL_GET_LAST_RESTART_SLOT,
                             vm.SYSCALL_SOL_GET_EPOCH_REWARDS, vm.SYSCALL_SOL_GET_CLOCK,
                             vm.SYSCALL_SOL_GET_RENT, vm.SYSCALL_SOL_GET_EPOCH_SCHEDULE)):
        out += [call(m, sid, INP + 128 * k), get(m, 128 * k, 128)]
    m.sysvars = {}
    out.append(call(m, vm.SYSCALL_SOL_GET_CLOCK, INP))
    assert int.from_bytes(out[1][:8], "little") == 5000 and out[5][80] == 0
    return out


def _return_data(vm, m):
    m.program_id = b"R" * 32
    put(m, 0, b"returned")
    out = [call(m, vm.SYSCALL_SOL_SET_RETURN_DATA, INP, 8),
           call(m, vm.SYSCALL_SOL_GET_RETURN_DATA, INP + 100, 4, INP + 200),
           get(m, 100, 8), get(m, 200, 32), m.return_data]
    try:
        call(m, vm.SYSCALL_SOL_SET_RETURN_DATA, INP, vm.MAX_RETURN_DATA + 1)
    except vm.VmError as e:
        out.append(str(e))
    return out


def _secp256k1_recover(vm, m):
    from firedancer_tpu_torch.ops import secp256k1 as sk

    h = hashlib.sha256(b"recover me").digest()
    sig, rec = sk.sign(12345, h)
    put(m, 0, h)
    put(m, 32, sig)
    return [call(m, vm.SYSCALL_SOL_SECP256K1_RECOVER, INP, rec, INP + 32, INP + 100),
            get(m, 100, 64),
            call(m, vm.SYSCALL_SOL_SECP256K1_RECOVER, INP, rec ^ 1, INP + 32, INP + 200),
            get(m, 200, 64)]


def _log_pubkey_data_panic(vm, m):
    logs = []
    vm.register_default_syscalls(m, log_sink=logs)
    put(m, 0, bytes(range(32)))
    put(m, 100, INP.to_bytes(8, "little") + (32).to_bytes(8, "little"))
    out = [call(m, vm.SYSCALL_SOL_LOG_PUBKEY, INP), call(m, vm.SYSCALL_SOL_LOG_DATA, INP + 100, 1)]
    put(m, 200, b"lib.rs")
    try:
        call(m, vm.SYSCALL_SOL_PANIC, INP + 200, 6, 12, 34)
    except vm.VmError as e:
        out.append(str(e))
    return out + [logs]


SYSCALL_CASES = {f.__name__[1:]: f for f in (
    _blake3, _poseidon, _big_mod_exp, _bn128_compression, _bn128_group_op, _bn128_pairing,
    _curve_validate, _curve_group_ops, _curve_msm, _introspection, _sibling, _sysvar_getters,
    _return_data, _secp256k1_recover, _log_pubkey_data_panic)}


@pytest.mark.parametrize("name", sorted(SYSCALL_CASES))
def test_syscall_matches_jax(name):
    outs = []
    for vm, sbpf, _ in PKGS:
        m = mkvm(vm, sbpf)
        res = SYSCALL_CASES[name](vm, m)
        outs.append((res, m.cu_used, bytes(m.regions[3].data), list(m.logs)))
    assert outs[1] == outs[0]
    if name == "blake3":
        assert outs[1][0][1] == blake3_host(b"blake3 syscall")
    if name == "poseidon":
        assert outs[1][0][1] == bytes([230, 117, 27, 127, 210, 224, 145, 185, 157, 99, 172, 7,
                                       132, 30, 241, 130, 136, 166, 99, 99, 197, 198, 25, 204,
                                       119, 97, 238, 129, 229, 172, 191, 5])
    if name == "big_mod_exp":
        assert outs[1][0][:2] == [0, pow(7, 5, 13).to_bytes(8, "big")]
    if name == "bn128_pairing":
        assert outs[1][0] == [0, (1).to_bytes(32, "big")]


def test_executor_records_instr_trace():
    """Two top-level system transfers leave two height-1 trace entries, on
    both executors alike."""
    traces = []
    for ex_mod in (jex, tex):
        a = ex_mod.Account(hashlib.sha256(b"ta").digest(), 1000, bytes(32), False, bytearray())
        b = ex_mod.Account(hashlib.sha256(b"tb").digest(), 0, bytes(32), False, bytearray())
        ctx = ex_mod.TxnCtx(accounts=[a, b], signer=[True, False], writable=[True, True])
        data = (2).to_bytes(4, "little") + (5).to_bytes(8, "little")
        for _ in range(2):
            ex_mod.Executor().execute_instr(ctx, bytes(32), [ex_mod.InstrAccount(0, True, True),
                                                             ex_mod.InstrAccount(1, False, True)],
                                            data)
        traces.append((ctx.instr_trace, ctx.cu_used))
    assert traces[1] == traces[0]
    assert [h for h, *_ in traces[1][0]] == [1, 1]
