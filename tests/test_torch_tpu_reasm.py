"""The port's TPU reassembler (runtime/tpu_reasm.py) against the JAX
package's: seeded append, fin, cancel and eviction sequences give the same
outputs, metrics and active() after every call, exactly."""

import numpy as np
import pytest

from firedancer_tpu.runtime.tpu_reasm import TpuReasm as JReasm
from firedancer_tpu_torch.runtime.tpu_reasm import TpuReasm as TReasm


def _ops(seed: int, n: int, n_keys: int):
    """n seeded calls over n_keys stream keys: appends of 0-700 bytes (a
    fin one time in four), now and then a cancel; streams long enough to
    cross the 1,232-byte MTU occur."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        key = ("peer", int(rng.integers(n_keys)))
        if rng.random() < 0.08:
            yield ("cancel", key)
            continue
        data = rng.integers(0, 256, int(rng.integers(0, 700)), dtype=np.uint8).tobytes()
        yield ("append", key, data, bool(rng.random() < 0.25))


@pytest.mark.parametrize("seed,depth,n_keys", [(1, 4, 6), (2, 2, 9), (3, 64, 12), (4, 1, 3)])
def test_seeded_sequences_equal_the_jax_reassembler(seed, depth, n_keys):
    j, t = JReasm(depth=depth), TReasm(depth=depth)
    outs = []
    for op in _ops(seed, 600, n_keys):
        if op[0] == "cancel":
            r = (t.cancel(op[1]), j.cancel(op[1]))
        else:
            r = (t.append(op[1], op[2], fin=op[3]), j.append(op[1], op[2], fin=op[3]))
        assert r[0] == r[1], op
        assert t.active() == j.active()
        assert t.metrics == j.metrics
        outs.append(r[0])
    # the sequence exercised every path
    assert any(isinstance(o, bytes) for o in outs)
    assert t.metrics["published"] > 0 and t.metrics["oversz"] > 0
    assert t.metrics["cancelled"] > 0
    if depth < n_keys:
        assert t.metrics["evicted"] > 0


def test_oversize_tombstone_swallows_continuations_until_fin():
    for r in (TReasm(depth=2), JReasm(depth=2)):
        assert r.append("a", b"x" * 1000) is None
        assert r.append("a", b"x" * 300) is None  # past the MTU: tombstoned
        assert r.append("a", b"y" * 10) is None   # swallowed, no fresh slot
        assert r.active() == 1 and r.metrics["oversz"] == 1
        assert r.append("a", b"", fin=True) is None  # FIN clears it
        assert r.active() == 0
        assert r.append("a", b"ok", fin=True) == b"ok"
    with pytest.raises(ValueError):
        TReasm(depth=0)
