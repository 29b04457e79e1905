"""``assess_ms``: host time of the balancer's cost assessment per LB round
(the ``dlb.measure`` spans: counters, heuristic or the activity ledger's
timed deposits) over the traced stretch."""
from portbench.metrics._spans import host_ms_per_span


def read(ctx):
    return host_ms_per_span(ctx, "dlb.measure")
