"""Seconds from the start of the process to the start of the window:
imports, the kernel library's build or load, inputs, tuning, the checked
first steps and the warm-up call."""


def read(ctx):
    return ctx.setup_s
