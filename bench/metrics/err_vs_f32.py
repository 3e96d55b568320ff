"""The program's relative reconstruction error of the input over the plain
f32 reference's on the same input and key, averaged over the compared
calls."""


def read(ctx):
    cmp = ctx["compared"]
    if not cmp:
        return None
    return sum(c["err"] / c["err_ref"] for c in cmp) / len(cmp)
