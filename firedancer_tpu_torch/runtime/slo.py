"""Per-hop latency budgets over the metrics plane (the port's copy of
firedancer_tpu/runtime/slo.py): a ratchet, not a dashboard.

Each stage records `frag_latency_ns` (now - tsorig a consumed frag, tsorig
stamped once at the origin stage), so a hop's latency is a quantile of its
histogram.  The tables below hold the JAX package's budgets, loose enough
to catch a regression (a stage reverting to per-frag batching, a deadline
wedged open, a lane falling back) and not scheduler noise; a test or the
chip script checks a run's registries against them with
`check_hop_budgets`.  "store" observes the whole ingress -> store path
(its tsorig is benchg's), so its row is the end-to-end budget.
"""
from __future__ import annotations

# hop (stage name in the flagship cooperative pipeline) -> p50 budget, ns.
# "store" observes the whole ingress->...->store path (its tsorig is
# benchg's), so its row IS the e2e budget.
HOP_P50_BUDGET_NS: dict[str, int] = {
    "verify0": 100_000_000,   # ingress -> verify (batch close included)
    "dedup": 150_000_000,     # python lane only (fused lane has no hop)
    "pack": 200_000_000,      # ingress -> pack intake (dedup hop included)
    "bank0": 250_000_000,     # ingress -> commit (microblock close incl.)
    "store": 450_000_000,     # end to end
}

# hop -> p99 budget, ns: the tail ratchet.  bank0's row is the commit
# p99 (ingress -> microblock commit, the bank A/B artifact's
# commit_p99_ms cousin); store's is the end-to-end tail.  Kept to the
# two hops whose tails the bench rounds actually track — a p99 on a
# mid-pipe hop would only re-measure its consumers' scheduling noise.
HOP_P99_BUDGET_NS: dict[str, int] = {
    "bank0": 500_000_000,
    "store": 700_000_000,
}


def check_hop_budgets(hists: dict[str, dict]) -> list[str]:
    """hists: stage name -> frag_latency_ns histogram dict (the
    MetricsRegistry.hist / Metrics.hist shape).  Returns human-readable
    violations; empty = within budget.  Stages without a budget row or
    without observations are skipped (a hop that consumed nothing has no
    quantile; the caller asserts traffic separately)."""
    from ..utils.metrics import hist_quantile

    out = []
    for q, table in ((0.5, HOP_P50_BUDGET_NS), (0.99, HOP_P99_BUDGET_NS)):
        for name, budget in table.items():
            h = hists.get(name)
            if not h or not h.get("count"):
                continue
            v = hist_quantile(h, q)
            if v > budget:
                out.append(
                    f"{name}: p{int(q * 100)} {v / 1e6:.1f}ms exceeds "
                    f"budget {budget / 1e6:.1f}ms"
                )
    return out
