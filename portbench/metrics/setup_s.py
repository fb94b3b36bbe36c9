"""Seconds from the process's start to the window's: imports, the
kernel build (first run of a checkout only), planning and warm-up."""


def read(ctx):
    return ctx.setup_s
