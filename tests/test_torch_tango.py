"""The port's shared-memory links against the JAX package's, across the
package boundary: a segment either package creates, the other attaches by
name with the same geometry, and a stream published by one package's
producer and read by the other's consumer, on every pair of lanes (Python
or native at each end), logs the same publish outcomes, metas, payloads,
fseq values and ovrn_cnt as the port's Python lane alone
(tests/test_torch_native_ring.py's op scripts).
"""

from __future__ import annotations

import pytest

from firedancer_tpu.tango import shm as jshm
from firedancer_tpu_torch.tango import rings as trings
from firedancer_tpu_torch.tango import shm as tshm
from tests.test_torch_native_ring import (
    LANES,
    REFERENCE,
    SHAPES,
    lane_log,
    make_link,
    op_script,
    run_script,
)

ATTACH = {"port": tshm.ShmLink.attach, "jax": jshm.ShmLink.join}
MOD = {"port": tshm, "jax": jshm}


@pytest.mark.parametrize("maker,joiner", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("dcache_sz", [None, trings.DCache.footprint(512, 32) + 4096])
def test_segment_attaches_across_packages(maker, joiner, dcache_sz):
    link = MOD[maker].ShmLink.create(f"fdtpu_torch_ta_{tshm.fresh_uid()}", depth=32, mtu=512,
                                     n_fseq=3, dcache_sz=dcache_sz)
    other = ATTACH[joiner](link._shm.name.lstrip("/"))
    try:
        assert (other.depth, other.mtu, other.n_fseq, other.dcache_sz) == \
            (link.depth, link.mtu, link.n_fseq, link.dcache_sz)
        prod = MOD[maker].Producer(link)
        assert prod.try_publish(b"across", sig=(1 << 63) | 9, tsorig=77)
        res = MOD[joiner].Consumer(other, 2, 0).poll()
        assert isinstance(res, tuple)
        meta, payload = res
        assert payload == b"across"
        assert [int(meta[c]) for c in (0, 1, 3, 5)] == [0, (1 << 63) | 9, 6, 77]
        assert link.fseqs[2].query() == 1  # the joiner's progress, seen by the maker
        assert int(link.mcache.table[1, 0]) == trings.MCache.BUSY | 1  # untouched line
    finally:
        del prod
        other.close()
        link.close()
        link.unlink()


CROSS = [(p, c) for p in LANES for c in LANES if p.split("-")[0] != c.split("-")[0]]


def cross_log(prod_lane: str, cons_lane: str, shape: str, seed: int) -> list:
    """The op script with the producer on one package's link and the
    consumer on the other package's attachment of it."""
    reliable, lazy, n_steps = SHAPES[shape]
    pmod, prod_cls, _ = LANES[prod_lane]
    cmod, _, cons_cls = LANES[cons_lane]
    link = make_link(pmod, "x")
    other = ATTACH["port" if cmod is tshm else "jax"](link._shm.name.lstrip("/"))
    try:
        prod, cons = prod_cls(link, reliable), cons_cls(other, 0, lazy)
        log = run_script(lambda: link.fseqs[0].query(), prod, cons, op_script(seed, n_steps))
        del prod, cons
        return log
    finally:
        other.close()
        link.close()
        link.unlink()


@pytest.mark.parametrize("shape", ["credit", "overrun"])
@pytest.mark.parametrize("pair", CROSS, ids=["/".join(p) for p in CROSS])
def test_stream_crosses_the_package_boundary(pair, shape):
    ref = lane_log(*REFERENCE, shape, 7)
    got = cross_log(*pair, shape, 7)
    assert got == ref
    assert got[-1][1] == ref[-1][1]  # ovrn_cnt
