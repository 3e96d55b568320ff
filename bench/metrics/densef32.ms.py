"""Device milliseconds a decomposition outside the projection and QR / SVD
ranges: the f32 products, unfoldings and copies of the entry."""


def read(ctx):
    t = ctx["trace"]
    spent = t["layers"].get("other", 0.0)
    return spent / t["decomps"] * 1e3 if spent > 0 else None
