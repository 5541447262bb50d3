"""The port's shred path against the JAX package, byte for byte: the
Shredder (parity through K5's plain version on the CPU) against
firedancer_tpu's Shredder (its host RS encoder) on 1 KB, 40 KB and 100 KB
entry batches, with the same host signer; the FecResolver fed the same
shreds with up to p of each set dropped (recovery through K5's plain
version); deshred_entry_batch and entry_batch_from_sets round trips; and
the shred wire format and merkle tree helpers.  Inputs are made with
numpy from a seed and handed to both packages."""

import hashlib

import numpy as np
import pytest

from firedancer_tpu.ops import bmtree as jbm
from firedancer_tpu.ops.ref import ed25519_ref as jref
from firedancer_tpu.protocol import shred as jfs
from firedancer_tpu.runtime import fec_resolver as jfr
from firedancer_tpu.runtime import shred_stage as jss
from firedancer_tpu.runtime import shredder as jsh
from firedancer_tpu_torch.ops import bmtree as tbm
from firedancer_tpu_torch.ops.ref import ed25519_ref as tref
from firedancer_tpu_torch.protocol import shred as tfs
from firedancer_tpu_torch.runtime import fec_resolver as tfr
from firedancer_tpu_torch.runtime import shred_stage as tss
from firedancer_tpu_torch.runtime import shredder as tsh
from firedancer_tpu_torch.utils import kbuild

SECRET = hashlib.sha256(b"shred-leader").digest()
SIZES = [1024, 40 * 1024, 100 * 1024]


def _batch(sz: int) -> bytes:
    """An entry batch of `sz` bytes: entry frames of seeded random bytes,
    each u32 length-prefixed as the shred stage serialises them."""
    rng = np.random.default_rng(sz)
    out = bytearray()
    while len(out) < sz:
        rem = sz - len(out) - 4
        n = int(rng.integers(100, 3000))
        n = rem if rem - n < 104 else n
        out += n.to_bytes(4, "little") + rng.bytes(n)
    assert len(out) == sz
    return bytes(out)


@pytest.fixture(scope="module")
def shredded():
    """{size: (jax sets, port sets)}, two batches per shredder (the second
    continues the slot's shred indices)."""
    out = {}
    for sz in SIZES:
        js = jsh.Shredder(signer=lambda r: jref.sign(SECRET, r), shred_version=3)
        ts = tsh.Shredder(signer=lambda r: tref.sign(SECRET, r), shred_version=3,
                          device="cpu")
        sets = ([], [])
        for k, meta_done in enumerate((False, True)):
            batch = _batch(sz + k)
            jm = jsh.EntryBatchMeta(reference_tick=k + 1, block_complete=meta_done)
            tm = tsh.EntryBatchMeta(reference_tick=k + 1, block_complete=meta_done)
            sets[0].extend(js.entry_batch_to_fec_sets(batch, slot=7, meta=jm))
            sets[1].extend(ts.entry_batch_to_fec_sets(batch, slot=7, meta=tm))
        out[sz] = sets
    return out


@pytest.mark.parametrize("sz", SIZES)
def test_shredder_equals_jax(shredded, sz):
    js, ts = shredded[sz]
    assert len(ts) == len(js) >= 2
    for a, b in zip(js, ts):
        assert (b.slot, b.fec_set_idx, b.merkle_root) == (a.slot, a.fec_set_idx, a.merkle_root)
        assert b.data_shreds == a.data_shreds
        assert b.parity_shreds == a.parity_shreds


@pytest.mark.parametrize("sz", SIZES)
def test_shred_counts_equal_jax(sz):
    for fn in ("count_fec_sets", "count_data_shreds", "count_parity_shreds"):
        assert getattr(tsh, fn)(sz) == getattr(jsh, fn)(sz)


def _drop(sets, seed: int):
    """Every shred of every set in wire order, up to p of each set dropped
    (seeded), then the whole stream shuffled."""
    rng = np.random.default_rng(seed)
    stream = []
    for st in sets:
        shreds = list(st.data_shreds) + list(st.parity_shreds)
        k = int(rng.integers(0, len(st.parity_shreds) + 1))
        gone = set(rng.choice(len(shreds), k, replace=False).tolist())
        stream += [s for i, s in enumerate(shreds) if i not in gone]
    rng.shuffle(stream)
    return stream


@pytest.mark.parametrize("sz", SIZES)
@pytest.mark.parametrize("trust", [False, True])
def test_fec_resolver_equals_jax(shredded, sz, trust):
    js, _ = shredded[sz]
    stream = _drop(js, sz + trust)
    pub = jref.public_key(SECRET)
    jr = jfr.FecResolver(verify_sig=None if trust else lambda r, s: jref.verify(r, s, pub),
                         trust_membership=trust)
    tr = tfr.FecResolver(verify_sig=None if trust else lambda r, s: tref.verify(r, s, pub),
                         trust_membership=trust, device="cpu")
    kbuild.reset_launches()
    jout = [x for x in map(jr.add_shred, stream) if x is not None]
    tout = [x for x in map(tr.add_shred, stream) if x is not None]
    assert len(tout) == len(jout) == len(js)
    for a, b in zip(jout, tout):
        assert (b.slot, b.fec_set_idx, b.merkle_root) == (a.slot, a.fec_set_idx, a.merkle_root)
        assert b.data_shreds == a.data_shreds
        assert b.parity_shreds == a.parity_shreds
    assert tr.metrics == jr.metrics
    assert sum(kbuild.LAUNCHES.values()) == 0
    # the rebuilt sets are the produced ones
    by_idx = {s.fec_set_idx: s for s in js}
    for b in tout:
        assert b.data_shreds == by_idx[b.fec_set_idx].data_shreds


def test_fec_resolver_rejects_like_jax(shredded):
    js, _ = shredded[SIZES[1]]
    st = js[0]
    bad = bytearray(st.data_shreds[3])
    bad[200] ^= 1  # breaks the merkle membership proof
    stream = [bytes(bad), b"\x00" * 10, st.data_shreds[0], st.data_shreds[0]]
    stream += list(st.parity_shreds[:2])
    jr = jfr.FecResolver()
    tr = tfr.FecResolver(device="cpu")
    assert [jr.add_shred(s) is None for s in stream] == [tr.add_shred(s) is None for s in stream]
    assert tr.metrics == jr.metrics


@pytest.mark.parametrize("sz", SIZES)
def test_deshred_round_trip(shredded, sz):
    js, ts = shredded[sz]
    n1 = len(tsh.Shredder(signer=lambda r: bytes(64), device="cpu")
             .entry_batch_to_fec_sets(_batch(sz), slot=7))
    batch = tfr.entry_batch_from_sets(ts[:n1])
    assert batch == _batch(sz)
    assert batch == jfr.entry_batch_from_sets(js[:n1])
    frames = tss.deshred_entry_batch(batch)
    assert frames == jss.deshred_entry_batch(batch)
    assert b"".join(len(f).to_bytes(4, "little") + f for f in frames) == batch


def test_shred_format_and_bmtree_equal_jax():
    rng = np.random.default_rng(11)
    leaves = [rng.bytes(32) for _ in range(13)]
    assert tbm.tree_layers(leaves) == jbm.tree_layers(leaves)
    assert tbm.root32(leaves) == jbm.root32(leaves)
    layers = tbm.tree_layers([x[:tbm.NODE_SZ] for x in leaves])
    for i in range(13):
        proof = tbm.get_proof(layers, i)
        assert proof == jbm.get_proof(layers, i)
        assert tbm.verify_proof(leaves[i], i, proof) == tbm.root32(leaves)
    assert [tbm.depth(n) for n in range(70)] == [jbm.depth(n) for n in range(70)]
    kw = dict(slot=9, idx=4, version=2, fec_set_idx=0, parent_off=1, flags=0x41,
              payload=rng.bytes(500), merkle_proof_cnt=6)
    assert tfs.build_data_shred(**kw) == jfs.build_data_shred(**kw)
    buf = bytes(tfs.build_data_shred(**kw))
    assert tfs.parse(buf) == tfs.Shred(*jfs.parse(buf).__dict__.values())
