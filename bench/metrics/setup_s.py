"""Seconds from the harness's start to the end of the warm-up: imports, the
card's start, the input pool, kernel builds and plan picks."""


def read(ctx):
    return ctx["setup_s"]
