"""``dispatch_ms``: the program's own host clock for issuing the intervals
(``pipeline_stats()["dispatch_s"]``), per step of the untraced window."""


def read(ctx):
    if "dispatch_s" not in ctx.host or not ctx.host.get("steps"):
        return None
    return 1e3 * ctx.host["dispatch_s"] / ctx.host["steps"]
