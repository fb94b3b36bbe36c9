"""The card's peak of allocated memory over the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return ctx.peak_bytes / 2**30
