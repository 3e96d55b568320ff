"""The share of the traced window in which no device operation runs: the
window less the union of the device intervals, in percent."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
