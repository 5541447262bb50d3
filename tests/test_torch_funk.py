"""The port's dict funk (firedancer_tpu_torch/funk/funk.py) against the JAX
package's, op for op.

Seeded random op streams (numpy seeds) mix prepare, publish, cancel,
insert, remove, query, keys, the frozen check, ancestry and the batched
writer (`txn_recs_for_write`), with deliberately stale or unknown xids and
keys: every return value and every FunkError code (-1 unknown txn, -2
frozen, -3 unknown key) must be equal, and so must the root state, the txn
count, the root record count and last_publish at the end.  Tolerance:
exact equality.  tests/test_torch_funk_native.py runs the same streams
through the port's shm map.
"""

from __future__ import annotations

import numpy as np
import pytest

from firedancer_tpu.funk import funk as jfunk
from firedancer_tpu_torch.funk import funk as tfunk

SEEDS = [1, 7, 23, 1337, 4096, 65537]
N_OPS = 400


def op_stream(seed: int, n_ops: int = N_OPS) -> list[tuple[str, tuple]]:
    """A seeded op stream over 8 keys.  Xids are drawn from those prepared so
    far (some published or cancelled since: the stale ones are the test) and
    a few that never exist; a tenth of the targets are root (None)."""
    rng = np.random.default_rng(seed)
    keys = [b"k%02d" % i for i in range(8)]
    prepared: list[bytes] = []
    ops = []
    for step in range(n_ops):
        roll = rng.random()
        if prepared and rng.random() < 0.9:
            xid = prepared[int(rng.integers(len(prepared)))]
        else:
            xid = b"ghost%d" % int(rng.integers(4))
        tx = None if rng.random() < 0.3 else xid
        key = keys[int(rng.integers(len(keys)))]
        if roll < 0.15:
            new = b"x%04d" % len(prepared)
            parent = (None if not prepared or rng.random() < 0.4
                      else prepared[int(rng.integers(len(prepared)))])
            prepared.append(new)
            ops.append(("prepare", (parent, new)))
        elif roll < 0.20:
            ops.append(("cancel", (xid,)))
        elif roll < 0.25:
            ops.append(("publish", (xid,)))
        elif roll < 0.45:
            ops.append(("insert", (tx, key, b"v%d.%d" % (seed, step))))
        elif roll < 0.50:
            ops.append(("batch", (xid, [(keys[int(k)], b"b%d.%d" % (step, j))
                                        for j, k in enumerate(rng.integers(8, size=3))])))
        elif roll < 0.60:
            ops.append(("remove", (tx, key)))
        elif roll < 0.78:
            ops.append(("query", (tx, key)))
        elif roll < 0.88:
            ops.append(("keys", (None if rng.random() < 0.5 else xid,)))
        elif roll < 0.93:
            ops.append(("frozen", (xid,)))
        elif roll < 0.97:
            ops.append(("ancestry", (xid,)))
        else:
            ops.append(("counts", ()))
    return ops


def apply_op(f, op: str, a: tuple, funk_error=(jfunk.FunkError, tfunk.FunkError)):
    """One op against one store: ("ok", result) or ("err", code), so the
    stores' outcomes compare as plain values."""
    try:
        if op == "prepare":
            return ("ok", f.txn_prepare(a[0], a[1]))
        if op == "cancel":
            return ("ok", f.txn_cancel(a[0]))
        if op == "publish":
            return ("ok", f.txn_publish(a[0]))
        if op == "insert":
            return ("ok", f.rec_insert(a[0], a[1], a[2]))
        if op == "batch":
            recs = f.txn_recs_for_write(a[0])
            for k, v in a[1]:
                recs[k] = v
            return ("ok", None)
        if op == "remove":
            return ("ok", f.rec_remove(a[0], a[1]))
        if op == "query":
            return ("ok", f.rec_query(a[0], a[1]))
        if op == "keys":
            return ("ok", sorted(f.rec_keys(a[0])))
        if op == "frozen":
            return ("ok", f.txn_is_frozen(a[0]))
        if op == "ancestry":
            return ("ok", f.txn_ancestry(a[0]))
        if op == "counts":
            return ("ok", (f.txn_cnt(), f.rec_cnt_root(), f.last_publish))
        raise AssertionError(op)
    except funk_error as e:
        return ("err", e.code)


def root_state(f) -> dict[bytes, bytes]:
    return {k: f.rec_query(None, k) for k in f.rec_keys(None)}


def end_state(f) -> tuple:
    return (root_state(f), f.txn_cnt(), f.rec_cnt_root(), f.last_publish)


def run_streams(stores: list, seed: int) -> list[list]:
    """Every op of the seed's stream through each store; the outcomes."""
    outs = [[] for _ in stores]
    for op, a in op_stream(seed):
        for f, out in zip(stores, outs):
            out.append((op, apply_op(f, op, a)))
    return outs


@pytest.mark.parametrize("seed", SEEDS)
def test_random_stream_equals_jax(seed):
    j, t = jfunk.Funk(), tfunk.Funk()
    oj, ot = run_streams([j, t], seed)
    for step, (rj, rt) in enumerate(zip(oj, ot)):
        assert rj == rt, f"step {step}: {rj} != {rt}"
    assert end_state(j) == end_state(t)
    # the streams reach every error code and both kinds of outcome
    codes = {r[1] for _op, r in ot if r[0] == "err"}
    assert codes <= {tfunk.ERR_TXN, tfunk.ERR_FROZEN, tfunk.ERR_KEY}


def test_streams_reach_every_error_code():
    codes = set()
    for seed in SEEDS:
        (out,) = run_streams([tfunk.Funk()], seed)
        codes |= {r[1] for _op, r in out if r[0] == "err"}
    assert codes == {tfunk.ERR_TXN, tfunk.ERR_FROZEN, tfunk.ERR_KEY}


def test_tombstone_hides_ancestors_and_keys():
    for mod in (jfunk, tfunk):
        f = mod.Funk()
        f.rec_insert(None, b"a", b"1")
        f.rec_insert(None, b"b", b"2")
        f.txn_prepare(None, b"p")
        f.rec_remove(b"p", b"a")
        f.txn_prepare(b"p", b"c")
        assert f.rec_query(b"c", b"a") is None
        assert sorted(f.rec_keys(b"c")) == [b"b"]
        f.rec_insert(b"c", b"a", b"3")
        assert sorted(f.rec_keys(b"c")) == [b"a", b"b"]
        with pytest.raises(mod.FunkError) as e:
            f.rec_remove(b"p", b"b")  # frozen: p has a child
        assert e.value.code == mod.ERR_FROZEN
        f.txn_cancel(b"c")
        with pytest.raises(mod.FunkError) as e:
            f.rec_remove(b"p", b"a")  # already tombstoned
        assert e.value.code == mod.ERR_KEY
        assert f.txn_publish(b"p") == 1
        assert root_state(f) == {b"b": b"2"}
        assert f.last_publish == b"p" and f.rec_cnt_root() == 1


def test_root_writes_go_through_root_merge():
    """Root inserts, removes and publishes all reach `_root_merge` (the
    funnel funk/persist.py journals), in the same batches as the JAX
    store's."""
    seen = {}
    for mod in (jfunk, tfunk):
        log = seen[mod] = []

        class Spy(mod.Funk):
            def _root_merge(self, items):
                log.append(list(items))
                super()._root_merge(items)

        f = Spy()
        f.rec_insert(None, b"a", b"1")
        f.rec_remove(None, b"a")
        f.txn_prepare(None, b"x")
        f.rec_insert(b"x", b"k", b"v")
        f.rec_remove(b"x", b"k")
        f.rec_insert(b"x", b"m", b"w")
        f.txn_publish(b"x")
    assert seen[jfunk] == seen[tfunk]
    assert seen[tfunk] == [[(b"a", b"1")], [(b"a", None)], [(b"k", None), (b"m", b"w")]]
