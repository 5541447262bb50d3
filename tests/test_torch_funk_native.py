"""The port's shm record map (funk/funk_native.py over native/fd_funk.cpp)
against the JAX package's dict funk and the port's, and the bank sweep's
native funk plane (native/fd_bank.cpp's in-crossing commit) against the
unarmed lanes.

  - test_torch_funk.py's seeded op streams go through the JAX `Funk`, the
    port's `Funk` and the port's `NativeFunk` at once: every return value
    and FunkError code, and the end state, equal (as the JAX package's
    tests/test_funk_native.py holds its own map);
  - `txn_diff` (the seal's one-crossing read-out) against the `_before`
    walk: the same rows, so the same lattice sum;
  - `rec_insert_batch` against per-record inserts; `attach_readonly` on a
    live store; `close()` removes the /dev/shm entry;
  - the bank sweep over a fixed frame stream (test_torch_bank_sweep's) on
    the shm store with the plane armed, with it disarmed, and on the dict
    store: the same entries, per-txn (status, fee, compute units), funk
    state and bank hash, `bank_funk_writes` > 0 and `bank_funk_falls` == 0
    armed; the JAX package's replay_block reproduces the armed lane's seal.

Tolerance: exact equality everywhere.
"""

from __future__ import annotations

import ctypes
import os
from types import SimpleNamespace

import numpy as np
import pytest

from firedancer_tpu.funk import funk as jfunk
from firedancer_tpu_torch.flamenco import runtime as trt
from firedancer_tpu_torch.funk import funk as tfunk
from firedancer_tpu_torch.funk import funk_native as tfn
from firedancer_tpu_torch.funk import make_funk
from firedancer_tpu_torch.ops import lthash as tlt
from firedancer_tpu_torch.runtime import bank as tbank
from tests import test_exec_native as js
from tests.test_torch_bank_sweep import SWEEP_STREAMS, drive, jax_replay, mb_frames, results
from tests.test_torch_exec_native import STREAMS, _port_world
from tests.test_torch_funk import SEEDS, apply_op, end_state, op_stream

FUNK_ERRORS = (jfunk.FunkError, tfunk.FunkError)


def _shm_path(f) -> str:
    return "/dev/shm/" + f.shm_name.lstrip("/")


@pytest.mark.parametrize("seed", SEEDS)
def test_random_stream_equals_jax_and_dict_store(seed):
    j, t = jfunk.Funk(), tfunk.Funk()
    with make_funk() as n:
        assert isinstance(n, tfn.NativeFunk)
        for step, (op, a) in enumerate(op_stream(seed)):
            rj, rt, rn = (apply_op(f, op, a, FUNK_ERRORS) for f in (j, t, n))
            assert rj == rt == rn, f"step {step}: {op}{a!r}: {rj} {rt} {rn}"
        assert end_state(j) == end_state(t) == end_state(n)


def _diff_case(seed: int):
    """A root of 24 keys, a parent fork and a slot fork off it, with random
    inserts (some back to the start value), removes and reads in the slot;
    returns (store, slot xid, the keys the slot touched)."""
    rng = np.random.default_rng(seed)
    keys = [b"acct%02d" % i for i in range(32)]

    def build(f):
        for k in keys[:24]:
            f.rec_insert(None, k, b"root:" + k)
        f.txn_prepare(None, b"parent")
        for k in keys[20:28]:
            f.rec_insert(b"parent", k, b"parent:" + k)
        f.rec_remove(b"parent", keys[2])
        f.txn_prepare(b"parent", b"slot")
        return f

    ops = []
    for step in range(60):
        k = keys[int(rng.integers(len(keys)))]
        r = rng.random()
        ops.append(("insert" if r < 0.6 else "remove" if r < 0.8 else "read", k,
                    b"v%d" % step if rng.random() < 0.8 else None))
    return build, ops


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_txn_diff_equals_the_before_walk(seed):
    """The rows seal() takes from txn_diff are the _before walk's: the
    touched-but-unchanged keys drop out either way (a key written back to
    its start value cancels), a removal is after None, and the lattice sums
    are equal."""
    build, ops = _diff_case(seed)
    d = build(tfunk.Funk())
    with build(make_funk()) as n:
        before = {}  # the walk's start-of-slot snapshot, as SlotExecution keeps it
        for kind, k, v in ops:
            start = before.setdefault(k, d.rec_query(b"parent", k))
            for f in (d, n):
                if kind == "insert":
                    f.rec_insert(b"slot", k, v if v is not None else (start or b"x"))
                elif kind == "remove" and f.rec_query(b"slot", k) is not None:
                    f.rec_remove(b"slot", k)
        walk = sorted((k, b, d.rec_query(b"slot", k)) for k, b in before.items())
        walk = [r for r in walk if r[1] != r[2]]
        diff = sorted(r for r in n.txn_diff(b"slot") if r[1] != r[2])
        assert diff == walk
        assert any(a is None for _k, _b, a in diff)

        def lattice(rows):
            vals, signs = [], []
            for k, b, a in rows:
                if b is not None:
                    vals.append(tlt.lthash_of(k + b))
                    signs.append(-1)
                if a is not None:
                    vals.append(tlt.lthash_of(k + a))
                    signs.append(1)
            return tlt.combine_device(np.stack(vals), np.asarray(signs, dtype=np.int8),
                                      device="cpu").numpy()

        assert np.array_equal(lattice(diff), lattice(walk))


def test_rec_insert_batch_equals_per_record_inserts():
    rng = np.random.default_rng(5)
    items = [(b"key%03d" % int(rng.integers(64)),
              None if rng.random() < 0.2 else bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                                                                 dtype=np.uint8)))
             for _ in range(200)]
    with make_funk() as a, make_funk() as b:
        for f in (a, b):
            for i in range(64):
                f.rec_insert(None, b"key%03d" % i, b"seed%d" % i)
            f.txn_prepare(None, b"t")
        a.rec_insert_batch(b"t", items)
        for k, v in items:
            if v is None:
                if b.rec_query(b"t", k) is not None:
                    b.rec_remove(b"t", k)
            else:
                b.rec_insert(b"t", k, v)
        assert sorted(a.rec_keys(b"t")) == sorted(b.rec_keys(b"t"))
        for k in a.rec_keys(b"t"):
            assert a.rec_query(b"t", k) == b.rec_query(b"t", k)
            assert bytes(a.rec_query_view(b"t", k)) == a.rec_query(b"t", k)
        a.rec_insert_batch(None, [(b"key000", None), (b"new", b"v")])  # the root funnel
        assert a.rec_query(None, b"key000") is None and a.rec_query(None, b"new") == b"v"


def test_attach_readonly_sees_the_live_store():
    with make_funk() as w:
        w.rec_insert(None, b"a", b"1")
        w.txn_prepare(None, b"x")
        r = tfn.NativeFunk.attach_readonly(w.shm_name)
        try:
            assert r.rec_query(None, b"a") == b"1"
            w.rec_insert(b"x", b"b", b"2")
            w.rec_insert(None, b"a", b"3")
            assert r.rec_query(b"x", b"b") == b"2" and r.rec_query(None, b"a") == b"3"
            assert r.txn_diff(b"x") == [(b"b", None, b"2")]
            assert r.seq() == w.seq() and r.seq() % 2 == 0
            with pytest.raises(tfn.NativeFunkError):
                r.rec_insert(None, b"c", b"4")
        finally:
            r.close()
        assert os.path.exists(_shm_path(w))  # a reader's close unlinks nothing


def test_close_removes_the_shm_entry():
    f = make_funk()
    path = _shm_path(f)
    assert os.path.basename(path).startswith("fdtpu_torch_funk_")
    assert os.path.exists(path)
    f.rec_insert(None, b"a", b"1")
    f.close()
    assert not os.path.exists(path)
    f.close()  # idempotent
    with pytest.raises(tfn.NativeFunkError):
        f.rec_query(None, b"a")
    with make_funk() as g:
        path = _shm_path(g)
    assert not os.path.exists(path)
    ctx = tbank.BankCtx(device="cpu")
    path = _shm_path(ctx.funk)
    ctx.close()
    assert not os.path.exists(path)


def test_full_map_raises_and_keeps_its_records():
    with make_funk(max_sz=1 << 20) as f:
        f.txn_prepare(None, b"t")
        big = bytes(4096)
        n = 0
        with pytest.raises(MemoryError):
            while True:
                f.rec_insert(b"t", b"k%06d" % n, big)
                n += 1
        assert n > 50  # the 1 MiB map holds its 512 KiB bucket table too
        assert all(f.rec_query(b"t", b"k%06d" % i) == big for i in range(n))


# -- the bank sweep's native funk plane -------------------------------------------


def _native_world():
    """_port_world's accounts on a NativeFunk."""
    funk, sc = _port_world()
    n = make_funk()
    n.rec_insert_batch(None, [(k, funk.rec_query(None, k)) for k in funk.rec_keys(None)])
    return n, sc


def _drive_on(funk, sc, frames):
    ctx = tbank.BankCtx(funk, slot=js.SLOT, status_cache=sc, device="cpu")
    ctx._sx = trt.SlotExecution(funk, slot=js.SLOT, status_cache=sc,
                                slot_hashes=js.SLOT_HASHES, device="cpu")
    return drive(frames, sweep=True, ctx=ctx), ctx


def _state(funk, xid, keys) -> dict:
    return {k: funk.rec_query(xid, k) for k in keys}


@pytest.mark.parametrize("name", SWEEP_STREAMS)
def test_bank_sweep_funk_plane_armed_equals_disarmed(name, monkeypatch):
    make, batch = STREAMS[name]
    frames = mb_frames(make(), min(batch, 4))
    d_funk, d_sc = _port_world()
    dict_run, d_ctx = _drive_on(d_funk, d_sc, frames)
    keys = sorted(set(d_funk.rec_keys(d_ctx.sx.xid)) | set(d_ctx.sx._before))
    a_funk, a_sc = _native_world()
    n_funk, n_sc = _native_world()
    try:
        armed, a_ctx = _drive_on(a_funk, a_sc, frames)
        with monkeypatch.context() as m:
            m.setattr(tbank.BankStage, "_arm_funk", lambda self: None)
            disarmed, n_ctx = _drive_on(n_funk, n_sc, frames)
        rep = armed[0]
        assert rep["bank_funk_writes"] > 0 and rep["bank_funk_falls"] == 0
        assert rep["bank_funk_writes"] <= rep["bank_txn_native"]
        assert disarmed[0]["bank_funk_writes"] == 0 == dict_run[0]["bank_funk_writes"]
        # the shm lanes keep no per-write snapshot: seal reads txn_diff
        assert a_ctx.sx._funk_diff and not d_ctx.sx._funk_diff
        for run in (armed, disarmed):
            assert run[1] == dict_run[1]  # entry frames, byte for byte
            assert results(run[3]) == results(dict_run[3])  # status, fee, compute units
            assert run[3].bank_hash == dict_run[3].bank_hash
        s_dict = _state(d_funk, d_ctx.sx.xid, keys)
        assert _state(a_funk, a_ctx.sx.xid, keys) == s_dict
        assert _state(n_funk, n_ctx.sx.xid, keys) == s_dict
        assert sorted(a_funk.rec_keys(a_ctx.sx.xid)) == sorted(d_funk.rec_keys(d_ctx.sx.xid))
        # the JAX package's replay over the wire entries reproduces the seal
        assert jax_replay(armed[4], monkeypatch).bank_hash == armed[3].bank_hash
    finally:
        a_funk.close()
        n_funk.close()


_INSERT_T = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                             ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32)


@pytest.mark.parametrize("refuse_every", [0, 3])
def test_failed_txn_compute_units_on_the_funk_plane(refuse_every, monkeypatch):
    """Landed txns that failed inside the crossing report the dict lane's
    compute units, counted from the response's charged instructions and not
    from the state: on the stripped log (refuse_every 0), and on groups that
    fell back to the full log after a partial in-crossing write (every
    `refuse_every`-th slot-direct insert refused), whose re-apply then
    leaves the dict lane's state and bank hash."""
    make, batch = STREAMS["random"]
    frames = mb_frames(make(), min(batch, 4))
    d_funk, d_sc = _port_world()
    dict_run, d_ctx = _drive_on(d_funk, d_sc, frames)
    failed = [r for r in results(dict_run[3]) if r[1] > 0 and r[0] != 0]
    assert failed and any(cu > 0 for _s, _f, cu in failed)
    keys = sorted(set(d_funk.rec_keys(d_ctx.sx.xid)) | set(d_ctx.sx._before))
    a_funk, a_sc = _native_world()
    try:
        if refuse_every:
            lib = tfn.load()
            real = ctypes.cast(lib.ffk_rec_insert_slot, _INSERT_T)
            calls = [0]

            def insert(h, ti, key, klen, val, vlen):
                calls[0] += 1
                if calls[0] % refuse_every == 0:
                    return -1
                return real(h, ti, key, klen, val, vlen)

            cb = _INSERT_T(insert)
            monkeypatch.setattr(tfn, "load", lambda: SimpleNamespace(
                ffk_txn_slot=lib.ffk_txn_slot, ffk_rec_insert_slot=cb))
        armed, a_ctx = _drive_on(a_funk, a_sc, frames)
        rep = armed[0]
        if refuse_every:
            assert rep["bank_funk_falls"] > 0 and calls[0] > refuse_every
        else:
            assert rep["bank_funk_falls"] == 0 and rep["bank_funk_writes"] > 0
        assert results(armed[3]) == results(dict_run[3])  # status, fee, compute units
        assert armed[3].bank_hash == dict_run[3].bank_hash
        assert _state(a_funk, a_ctx.sx.xid, keys) == _state(d_funk, d_ctx.sx.xid, keys)
    finally:
        a_funk.close()
