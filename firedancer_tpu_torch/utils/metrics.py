"""Histogram helpers for the stages' metrics (the port's own copies of
firedancer_tpu/utils/metrics.py:121 exp_buckets and :296 hist_quantile)."""

from __future__ import annotations

import numpy as np


def exp_buckets(lo: float, hi: float, n: int) -> tuple:
    """Log-spaced bucket edges (the fd_histf approximate-exponential shape)."""
    return tuple(float(x) for x in np.geomspace(lo, hi, n))


def hist_quantile(h: dict, q: float) -> float:
    """Upper-edge q-quantile estimate over a Metrics.hist() dict."""
    total = h["count"]
    if total == 0:
        return 0.0
    target = q * total
    run = 0
    for edge, c in zip(h["buckets"] + [float("inf")], h["counts"]):
        run += c
        if run >= target:
            return edge
    return float("inf")
