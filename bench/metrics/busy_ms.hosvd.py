"""Device milliseconds a decomposition: the union of the device intervals
over a traced block of calls after the window, over the block's calls.
What a decomposition costs the card, whatever pace the host sets."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return t["busy_s"] / t["decomps"] * 1e3
