"""The 95th percentile (nearest rank) of the window's call latencies: each
call timed by the host clock from the call until its outputs are
synchronized."""

import math


def read(ctx):
    lat = sorted(ctx["window"]["latencies_s"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
