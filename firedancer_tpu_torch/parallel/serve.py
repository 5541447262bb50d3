"""The serving plane: the leader's device step over the mesh, and the stage
that pushes live pipeline frags through it (the port's counterpart of
firedancer_tpu/parallel/serve.py).

The JAX plane compiles ONE pjit program carrying three lanes, each
data-parallel over the mesh: ed25519 verify (the txn batch), Reed-Solomon
parity (the shredder's FEC sets) and PoH span re-verification (the PoH
stage's tick-span self-audit).  Here a step is, on each shard's device and
current stream, one launch of K1 over the shard's verify lanes (pad lanes
masked and counted on the card), then K4 over the shard's parked PoH
chains; the cross-shard count is a host sum of the per-shard counts.

One difference from the JAX step: a lane with no real work is not
launched.  Its outputs are still what the JAX step returns for it: parity
of the placeholder FEC sets is all zeros, and poh_ok is all False when no
span is parked.  (At full width a PoH span is 12,500 hashes; running K4
over placeholder chains every step would add a whole span's latency to
every verify batch.)  The FEC lane of a step always carries placeholders,
as in the JAX plane; the shredder's parity goes through encode_parity.

Lane geometry is fixed per config: shard i owns verify lanes
[i * batch_per_shard, (i + 1) * batch_per_shard); the frag->shard
assignment is the router's `seq % n_shards`, carried by which per-shard
link a frag arrived on.  encode_parity and verify_poh_segments split their
sets or chains over the mesh at any shape (K5 and K4 take their sizes at
run time); nothing goes to a host encoder.

Warm boot: kernels are built by nvcc into the hash-keyed
build/torch_kernels/ cache (utils/kbuild.py), the counterpart of the JAX
plane's serialized executable; `warmup()` builds and loads them, puts the
placeholders and the RS matrix on the devices and runs one step at the
config's shapes.  Capturing the step in a CUDA graph is later work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import reedsol as rs
from ..ops import sha256 as fsha
from ..ops import sigverify as sv
from ..runtime import poh as rpoh
from ..runtime.verify import DEFAULT_MAX_INFLIGHT, VerifyStage, _Acc, _Pending
from ..utils import kbuild
from .mesh import make_mesh

AXIS = "verify"
PLANE_KERNELS = ("verify", "sha256_iter32", "gf256_apply")


@dataclass(frozen=True)
class ServeConfig:
    """Static geometry of the serving step.

    The verify lanes carry the txn batch; the reedsol and PoH lanes carry
    the shredder's parity work and the PoH self-audit spans, sized small
    by default.
    """

    n_devices: int
    batch_per_shard: int = 128  # verify elements per shard
    max_msg_len: int = 256
    fec_sets_per_shard: int = 1  # RS sets per shard per step
    fec_data_shreds: int = 32  # d (the normal-FEC-set shape)
    fec_parity_shreds: int = 32  # p = parity_cnt_for(32)
    fec_shred_sz: int = 1024  # per-shred byte capacity (sz-padded)
    poh_chains_per_shard: int = 1
    poh_iters: int = 64  # pure-append span length (hashes_per_tick)
    axis: str = AXIS

    @property
    def batch(self) -> int:
        return self.batch_per_shard * self.n_devices

    @property
    def fec_sets(self) -> int:
        return self.fec_sets_per_shard * self.n_devices

    @property
    def poh_chains(self) -> int:
        return self.poh_chains_per_shard * self.n_devices

    def cache_key(self) -> str:
        return (
            f"d{self.n_devices}_b{self.batch_per_shard}_m{self.max_msg_len}"
            f"_f{self.fec_sets_per_shard}x{self.fec_data_shreds}"
            f"p{self.fec_parity_shreds}s{self.fec_shred_sz}"
            f"_h{self.poh_chains_per_shard}i{self.poh_iters}"
        )


def lane_real_mask(lane_count: int, per_shard: int, n_real) -> torch.Tensor:
    """THE pad-lane mask, one place: lane j belongs to shard j // per_shard
    and is real iff its index inside the shard is below that shard's fill."""
    n_real = torch.as_tensor(np.asarray(n_real, dtype=np.int64))
    lane = torch.arange(lane_count, dtype=torch.int64)
    return (lane % per_shard) < n_real[lane // per_shard]


def _split(n: int, n_shards: int) -> list[tuple[int, int, int]]:
    """(shard, lo, hi): contiguous ranges of n items over n_shards, empty ones
    dropped (shard i takes ceil(n / n_shards) items)."""
    per = -(-n // n_shards) if n else 0
    return [(i, i * per, min((i + 1) * per, n)) for i in range(n_shards)
            if i * per < n]


def _to(dev, a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


class Pending:
    """One serving step in flight: per-shard device results, the events
    recorded after each shard's launches, and the real-lane counts."""

    def __init__(self, ok, n_ok, parity, poh_ok, n_real, poh_real: int, events):
        self.ok = ok  # per shard (batch_per_shard,) bool, pads False
        self.n_ok = n_ok  # per shard () int32
        self.parity = parity  # per shard (fec_sets_per_shard, p, sz) uint8
        self.poh_ok = poh_ok  # per shard (poh_chains_per_shard,) bool
        self.n_real = n_real  # (n_devices,) verify fill per shard
        self.poh_real = poh_real
        self.events = events  # empty on the CPU, where everything ran

    def ready(self) -> bool:
        return all(e.query() for e in self.events)

    is_ready = ready  # the VerifyStage result protocol

    def mask_host(self) -> np.ndarray:
        return np.concatenate([m.cpu().numpy() for m in self.ok])

    def n_ok_host(self) -> int:
        return sum(int(c) for c in self.n_ok)

    def poh_ok_host(self) -> np.ndarray:
        return np.concatenate([m.cpu().numpy() for m in self.poh_ok])

    def parity_host(self) -> np.ndarray:
        return np.concatenate([p.cpu().numpy() for p in self.parity])


class ServePlane:
    """The mesh, its per-device placeholders, and the step."""

    def __init__(self, cfg: ServeConfig, device=None, mesh=None):
        self.cfg = cfg
        self.mesh = list(mesh) if mesh is not None else make_mesh(cfg.n_devices, device)
        if len(self.mesh) != cfg.n_devices:
            raise ValueError(f"{len(self.mesh)} devices for {cfg.n_devices} shards")
        self.device = self.mesh[0]
        self._placeholder = None  # per-shard zero parity, all-False poh_ok
        self.compile_s: float | None = None  # measured by warmup()
        # rider queue: PoH spans other stages park for the next step call
        self._poh_spans: list[tuple[bytes, bytes]] = []

    def _placeholders(self):
        """Device-resident placeholder outputs, built once: a verify-only
        step must not pay a host->device transfer for lanes that carry no
        work."""
        if self._placeholder is None:
            cfg = self.cfg
            self._placeholder = (
                [torch.zeros((cfg.fec_sets_per_shard, cfg.fec_parity_shreds,
                              cfg.fec_shred_sz), dtype=torch.uint8, device=dev)
                 for dev in self.mesh],
                [torch.zeros((cfg.poh_chains_per_shard,), dtype=torch.bool,
                             device=dev) for dev in self.mesh],
            )
        return self._placeholder

    def warmup(self) -> float:
        """Build and load the kernels, place the placeholders and the RS
        matrix, run one step (and one K4 and K5 launch per shard) at the
        config's shapes, synchronise.  Returns seconds."""
        t0 = time.monotonic()
        cfg = self.cfg
        if self.device.type == "cuda":
            kbuild.build_all(list(PLANE_KERNELS))
            for name in PLANE_KERNELS:
                kbuild.load(name)
        self._placeholders()
        b = cfg.batch
        pend = self.submit(np.zeros((cfg.max_msg_len, b), dtype=np.uint8),
                           np.zeros((b,), dtype=np.int32),
                           np.zeros((64, b), dtype=np.uint8),
                           np.zeros((32, b), dtype=np.uint8),
                           np.full((cfg.n_devices,), cfg.batch_per_shard),
                           riders=False)
        self.encode_parity(np.zeros((cfg.fec_sets, cfg.fec_data_shreds,
                                     cfg.fec_shred_sz), dtype=np.uint8),
                           cfg.fec_parity_shreds)
        chains = np.zeros((32, cfg.poh_chains), dtype=np.uint8)
        self.verify_poh_segments(chains, chains, cfg.poh_iters)
        pend.mask_host()
        for dev in self.mesh:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.compile_s = time.monotonic() - t0
        return self.compile_s

    # -- rider queue (the PoH stage parks spans for the next step) ----------

    def queue_poh_span(self, start: bytes, end: bytes) -> bool:
        """Park one pure-append PoH span (exactly cfg.poh_iters hashes) for
        device re-verification on the next step.  Bounded: drops (returns
        False) when a slot's worth is already pending."""
        if len(self._poh_spans) >= 4 * self.cfg.poh_chains:
            return False
        self._poh_spans.append((start, end))
        return True

    def _take_poh(self):
        """(per-shard (starts, ends, real) or None, spans taken)."""
        if not self._poh_spans:
            return [None] * self.cfg.n_devices, 0
        cfg = self.cfg
        take = self._poh_spans[: cfg.poh_chains]
        del self._poh_spans[: len(take)]
        starts = rpoh.hashes_to_rows([s for s, _ in take])
        ends = rpoh.hashes_to_rows([e for _, e in take])
        per = cfg.poh_chains_per_shard
        lanes = [None] * cfg.n_devices
        for i, dev in enumerate(self.mesh):
            lo, hi = i * per, min((i + 1) * per, len(take))
            if lo < hi:
                lanes[i] = (_to(dev, starts[:, lo:hi]), _to(dev, ends[:, lo:hi]),
                            hi - lo)
        return lanes, len(take)

    def verify_parked_poh(self) -> tuple[int, int]:
        """Run every parked PoH span through K4 now, as a step's PoH lane
        would (one launch per shard with spans, poh_chains spans a round):
        (spans ok, spans checked).  For the end of a stream, when no
        further step will carry them."""
        n_ok = n_all = 0
        while self._poh_spans:
            lanes, n = self._take_poh()
            for lane in lanes:
                if lane is not None:
                    st, en, _real = lane
                    got = (fsha.sha256_iter32(st, self.cfg.poh_iters) == en).all(dim=0)
                    n_ok += int(got.sum())
            n_all += n
        return n_ok, n_all

    # -- dispatch ------------------------------------------------------------

    def submit(self, msg, msg_len, sig, pk, n_real_per_shard,
               riders: bool = True) -> Pending:
        """One serving step over pre-padded (rows, batch) verify arrays, plus
        any parked PoH spans when riders=True.  Returns futures; pad lanes
        are already masked.  riders=False leaves the span queue alone, for
        callers that return only the verify mask."""
        cfg = self.cfg
        per = cfg.batch_per_shard
        parity, no_poh = self._placeholders()
        n_real = np.asarray(n_real_per_shard, dtype=np.int32)
        lanes, n_poh = self._take_poh() if riders else ([None] * cfg.n_devices, 0)
        arrs = [np.asarray(a) for a in (msg, msg_len, sig, pk)]
        oks, n_oks, poh_oks, events = [], [], [], []
        for i, dev in enumerate(self.mesh):
            args = [_to(dev, a[..., i * per:(i + 1) * per]) for a in arrs]
            ok, n_ok = sv.verify_batch(*args, int(n_real[i]),
                                       max_msg_len=cfg.max_msg_len)
            oks.append(ok)
            n_oks.append(n_ok)
            if lanes[i] is None:
                poh_oks.append(no_poh[i])
            else:
                st, en, real = lanes[i]
                got = (fsha.sha256_iter32(st, cfg.poh_iters) == en).all(dim=0)
                poh_ok = torch.zeros((cfg.poh_chains_per_shard,),
                                     dtype=torch.bool, device=dev)
                poh_ok[:real] = got
                poh_oks.append(poh_ok)
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
        return Pending(oks, n_oks, parity, poh_oks, n_real, n_poh, events)

    def verify_batch(self, msg, msg_len, sig, pk) -> Pending:
        """One step over a whole batch at the plane's exact batch shape (the
        VerifyStage plane hook): every lane counts as real, and riders=False
        leaves parked PoH spans for a caller that reads their results.
        Returns the step's Pending; mask_host() is the (batch,) ok mask."""
        b = self.cfg.batch
        if np.shape(msg)[1] != b:
            raise ValueError(f"plane step is shaped for batch {b}, got {np.shape(msg)[1]}")
        full = np.full((self.cfg.n_devices,), self.cfg.batch_per_shard, dtype=np.int32)
        return self.submit(msg, msg_len, sig, pk, full, riders=False)

    def encode_parity(self, data: np.ndarray, parity_cnt: int) -> np.ndarray:
        """Reed-Solomon parity for (nsets, d, sz) FEC sets of any (d, p, sz),
        the sets split over the mesh: one K5 launch per shard with sets."""
        data = np.asarray(data, dtype=np.uint8)
        nsets = data.shape[0]
        out = np.zeros((nsets, parity_cnt, data.shape[2]), dtype=np.uint8)
        pars = [(lo, hi, rs.encode(data[lo:hi], parity_cnt, device=self.mesh[i]))
                for i, lo, hi in _split(nsets, self.cfg.n_devices)]
        for lo, hi, par in pars:
            out[lo:hi] = par.cpu().numpy()
        return out

    def verify_poh_segments(self, starts, ends, iters: int) -> np.ndarray:
        """Equal-length PoH segment verification over (32, n) start/end byte
        rows of any length, the chains split over the mesh: one K4 launch
        per shard with chains."""
        starts = np.asarray(starts).astype(np.uint8)
        ends = np.asarray(ends).astype(np.uint8)
        n = starts.shape[1]
        oks = [(lo, hi, (fsha.sha256_iter32(_to(self.mesh[i], starts[:, lo:hi]), iters)
                         == _to(self.mesh[i], ends[:, lo:hi])).all(dim=0))
               for i, lo, hi in _split(n, self.cfg.n_devices)]
        out = np.zeros((n,), dtype=bool)
        for lo, hi, ok in oks:
            out[lo:hi] = ok.cpu().numpy()
        return out


# -- the serving stage ---------------------------------------------------------


class ShardedVerifyStage(VerifyStage):
    """The serving plane's pipeline position: ONE stage consuming the
    router's per-shard links and dispatching ONE step per batch.

    Each input link IS a shard: frags that arrived on link i fill shard i's
    lane range of the fixed-shape batch, so the router's `seq % n_shards`
    carries through to device placement (link i -> mesh device i) with no
    host-side reshuffle.  The step closes when any shard's lane range fills
    or the deadline passes; uneven fills pad and the step masks pad lanes
    on the card.  Intake (`_intake`) and the in-order drain with the
    all-signatures rule (`_drain`) are VerifyStage's.
    """

    def __init__(self, name: str, ins=None, outs=None, *, plane: ServePlane,
                 batch_deadline_s: float = 0.002,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT):
        cfg = plane.cfg
        super().__init__(name, ins, outs, device=plane.device,
                         batch=cfg.batch_per_shard, max_msg_len=cfg.max_msg_len,
                         batch_deadline_s=batch_deadline_s,
                         max_inflight=max_inflight,
                         comb_slots=0)  # the plane step IS the kernel choice
        self.plane = plane
        self.n_shards = cfg.n_devices
        # one accumulator per shard (per input link); VerifyStage's _gen
        # is unused on this subclass
        self._shards = [_Acc() for _ in range(self.n_shards)]
        self._elem_keys = [f"shard_elems_s{i}" for i in range(self.n_shards)]

    # the input link picks the shard: no drain-table intake, the per-frag
    # hooks see each frag's link
    sweep_frags = None

    # -- loop hooks --------------------------------------------------------

    def after_frag(self, in_idx: int, frag, payload: bytes) -> None:
        got = self._intake(payload)
        if got is None:
            return
        sigs, msg, signers, packed = got
        acc = self._shards[in_idx]
        if acc.elems and len(acc.elems) + len(sigs) > self.batch:
            # this shard's lane range is full: close the WHOLE step (the
            # fixed shape ships every shard's partial fill, masked)
            self._close_batch()
            acc = self._shards[in_idx]
        start = len(acc.elems)
        for s, pk in zip(sigs, signers):
            acc.elems.append((msg, s, pk))
        acc.ranges.append((start, len(acc.elems)))
        acc.payloads.append(payload)
        acc.descs.append(packed)
        acc.tsorigs.append(frag.tsorig)
        if len(acc.elems) >= self.batch:
            self._close_batch()

    def before_credit(self) -> None:
        for acc in self._shards:
            if acc.elems and acc.opened_at == 0.0:
                acc.opened_at = time.monotonic()

    def after_credit(self) -> None:
        if self._emit_queue:
            self._emit_burst([])
        now = time.monotonic()
        if any(acc.elems and acc.opened_at
               and now - acc.opened_at >= self.batch_deadline_s
               for acc in self._shards):
            self._close_batch()
        self._drain(block=False)

    def during_housekeeping(self) -> None:
        self._drain(block=False)

    # -- the sharded dispatch ------------------------------------------------

    def _close_batch(self, acc=None) -> None:
        """Close the WHOLE step (every shard's lane range); `acc` is unused:
        the shards' accumulators are the step's."""
        accs = self._shards
        n_elems = sum(len(a.elems) for a in accs)
        if n_elems == 0:
            return
        if len(self._inflight) >= self.max_inflight:
            self._drain(block=True)
        cfg = self.plane.cfg
        per = cfg.batch_per_shard
        b = cfg.batch
        msg = np.zeros((cfg.max_msg_len, b), dtype=np.uint8)
        ln = np.zeros((b,), dtype=np.int32)
        sg = np.zeros((64, b), dtype=np.uint8)
        pk = np.zeros((32, b), dtype=np.uint8)
        n_real = np.zeros((self.n_shards,), dtype=np.int32)
        merged = _Acc()
        for s, acc in enumerate(accs):
            base = s * per
            n_real[s] = len(acc.elems)
            if acc.elems:
                cols = slice(base, base + per)
                msg[:, cols], ln[cols], sg[:, cols], pk[:, cols] = self._assemble(acc)
            merged.payloads += acc.payloads
            merged.descs += acc.descs
            merged.ranges += [(a + base, e + base) for a, e in acc.ranges]
            merged.tsorigs += acc.tsorigs
            self.metrics.inc(self._elem_keys[s], len(acc.elems))
        self._shards = [_Acc() for _ in range(self.n_shards)]
        result = self.plane.submit(msg, ln, sg, pk, n_real)
        self._inflight.append(_Pending(merged, n_elems, result))
        self.metrics.inc("batches")
        self.metrics.inc("batch_elems", n_elems)
        self.metrics.observe("batch_fill", n_elems)

    def flush(self) -> None:
        self._close_batch()
        while self._inflight:
            self._drain(block=True)
        if self._emit_queue:
            self._emit_burst([])

    def audit_poh(self) -> None:
        """Verify the PoH spans still parked on the plane (the end of a
        stream: no further step carries them) and count them as a step's
        would be counted."""
        n_ok, n_all = self.plane.verify_parked_poh()
        if n_all:
            self.metrics.inc("poh_spans_ok", n_ok)
            self.metrics.inc("poh_spans_fail", n_all - n_ok)

    # the drain loop is VerifyStage._drain; this hook accounts for the PoH
    # self-audit spans that rode the step, exactly once, when its results
    # are consumed

    def _result_mask(self, head: _Pending) -> np.ndarray:
        pend: Pending = head.result
        if pend.poh_real:
            n_ok = int(pend.poh_ok_host().sum())
            self.metrics.inc("poh_spans_ok", n_ok)
            self.metrics.inc("poh_spans_fail", pend.poh_real - n_ok)
            pend.poh_real = 0
        return pend.mask_host()
