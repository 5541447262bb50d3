"""Batch-geometry autotuner for the verify stage (the port's counterpart of
firedancer_tpu/runtime/verify_tune.py, the same rules and constants).

The stage records the batch-fill histogram (elements per closed batch), the
message-length histogram and the generic/cached element counters; this
module turns them into a (batch, max_msg_len, comb split) recommendation.
On the card a new geometry only changes the shape of the next launch (the
kernels take their sizes at run time), but the stage still applies a
recommendation only at a quiet point, as the JAX stage does.

Pure and deterministic: the same histogram state always yields the same
recommendation, and the JAX package's recommend gives the same one.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils import metrics as fm

# the discrete ladders a recommendation picks from
BATCH_LADDER = (64, 128, 256, 512, 1024, 2048, 4096)
MSG_LEN_LADDER = (128, 256, 512, 1232)

FILL_TARGET_Q = 0.95  # size the batch so the p95 fill fits
MSG_LEN_Q = 0.99  # and the msg rows so the p99 length fits
COMB_SPLIT_MIN = 0.25  # cached lane earns its own batch above this share


@dataclass(frozen=True)
class Geometry:
    """One verify-stage shape choice."""

    batch: int
    max_msg_len: int
    comb_split: bool  # keep a separate cached-signer batch lane

    def as_dict(self) -> dict:
        return {
            "batch": self.batch,
            "max_msg_len": self.max_msg_len,
            "comb_split": self.comb_split,
        }


def _ladder_at_least(ladder: tuple, v: float) -> int:
    """Smallest ladder rung >= v (the top rung when v overflows)."""
    for rung in ladder:
        if rung >= v:
            return rung
    return ladder[-1]


def recommend(fill_hist: dict, msg_len_hist: dict | None = None, *,
              batch_elems: int = 0, comb_elems: int = 0,
              current: Geometry | None = None) -> Geometry:
    """The deterministic recommendation from one metrics snapshot.

    fill_hist / msg_len_hist: histogram dicts as Metrics.hist() returns them
    ({"buckets", "counts", "sum", "count"}).  batch_elems / comb_elems: the
    stage's element counters (the comb share decides the cached-lane split).
    `current` supplies fallbacks for axes with no evidence yet.
    """
    cur = current or Geometry(256, 1232, True)

    # batch: the ladder rung that holds the p95 observed fill
    if fill_hist and fill_hist.get("count"):
        q = fm.hist_quantile(fill_hist, FILL_TARGET_Q)
        if q == float("inf"):  # fills above the top edge: take the top rung
            batch = BATCH_LADDER[-1]
        else:
            batch = _ladder_at_least(BATCH_LADDER, q)
    else:
        batch = cur.batch

    # max_msg_len: every byte row is hashed, so size the rows to the p99
    # length; longer txns are dropped by the stage's guard
    if msg_len_hist and msg_len_hist.get("count"):
        q = fm.hist_quantile(msg_len_hist, MSG_LEN_Q)
        if q == float("inf"):
            mml = MSG_LEN_LADDER[-1]
        else:
            mml = _ladder_at_least(MSG_LEN_LADDER, q)
    else:
        mml = cur.max_msg_len

    # cached-lane split: a separate comb batch pays only when enough
    # traffic rides it
    total = batch_elems or 0
    comb = comb_elems or 0
    if total > 0:
        split = (comb / total) >= COMB_SPLIT_MIN
    else:
        split = cur.comb_split

    return Geometry(batch=batch, max_msg_len=mml, comb_split=split)


def recommend_for_stage(stage, current: Geometry | None = None) -> Geometry:
    """The live-stage entry point: recommend from the stage's own batch_fill
    and msg_len histograms and element counters.  Never touches the card."""
    m = stage.metrics
    try:
        fill = m.hist("batch_fill")
    except KeyError:
        fill = {}
    try:
        mlh = m.hist("msg_len")
    except KeyError:
        mlh = None
    return recommend(
        fill,
        mlh,
        batch_elems=m.get("batch_elems"),
        comb_elems=m.get("comb_elems"),
        current=current or Geometry(stage.batch, stage.max_msg_len,
                                    stage.comb_slots > 0),
    )
