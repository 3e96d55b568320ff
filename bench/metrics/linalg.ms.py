"""Device milliseconds a decomposition inside the ``linalg`` ranges
(``torch.linalg.qr`` and ``svd`` as the entry calls them)."""


def read(ctx):
    t = ctx["trace"]
    spent = t["layers"].get("linalg", 0.0)
    return spent / t["decomps"] * 1e3 if spent > 0 else None
