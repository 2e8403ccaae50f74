"""Seconds from the start of the benchmark's process to the start of the
first timed job: imports, the kernel library's load (its build in a
checkout's first run), the input pool and the warm-up jobs."""


def read(ctx):
    return ctx.setup_s
