"""``decide_ms``: host time of the balancer's decision per LB round (the
``dlb.decide`` spans: the knapsack and gate, on the sharded path with the
straggler observation, equal counts and locality repair; without the
assessment or the adoption) over the traced stretch."""
from portbench.metrics._spans import host_ms_per_span


def read(ctx):
    return host_ms_per_span(ctx, "dlb.decide")
