"""A decomposition's textbook operations (bench.work) times the window's
decompositions a second, over the card's dense bf16 tensor-core peak, in
percent."""

from bench import work


def read(ctx):
    w = ctx["window"]
    if not w["calls"]:
        return None
    rate = w["calls"] / w["seconds"]
    flops = work.decomp_flops(ctx["entry"], ctx["config"], ctx["traffic"])
    return 100.0 * flops * rate / work.PEAK_FLOP_PER_S
