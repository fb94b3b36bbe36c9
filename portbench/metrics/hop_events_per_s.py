"""Executed hops of every experiment in the window (every member of a
fleet), over the window's wall time on the host clock."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return ctx.hop_events / ctx.window_s
