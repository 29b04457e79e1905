"""``remake_ms``: host time to build the runtime at the start of each
stretch (the program's constructor on the inputs kept on the device), per
stretch of the untraced window."""


def read(ctx):
    return 1e3 * sum(ctx.remake_s) / len(ctx.remake_s) if ctx.remake_s else None
