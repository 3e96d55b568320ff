"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, so the input pool counts."""


def read(ctx):
    return ctx["window"]["peak_bytes"] / 2**30
