"""``balance_ms``: the program's own host clock for the bookkeeping,
balancer and adoption after each fetch (``pipeline_stats()["balance_s"]``),
per LB interval of the untraced window."""


def read(ctx):
    if "balance_s" not in ctx.host or not ctx.host.get("intervals"):
        return None
    return 1e3 * ctx.host["balance_s"] / ctx.host["intervals"]
