"""The projections' least time a decomposition (bench.work: 2 m n p
operations at the tensor-core peak or A read and Y written once at the
memory rate, the larger) over the device time a decomposition spends inside
the ``projection`` ranges, in percent."""

from bench import work


def read(ctx):
    t = ctx["trace"]
    spent = t["layers"].get("projection", 0.0) / t["decomps"]
    if spent <= 0:
        return None
    bound = work.projection_bound_per_decomp_s(ctx["entry"], ctx["config"],
                                               ctx["traffic"])
    return 100.0 * bound / spent
