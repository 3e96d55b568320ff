"""Decompositions completed in the window over its wall seconds (host
clock; the window ends on a synchronize)."""


def read(ctx):
    w = ctx["window"]
    return w["calls"] / w["seconds"] if w["calls"] else None
