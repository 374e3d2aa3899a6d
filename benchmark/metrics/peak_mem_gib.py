"""``torch.cuda.max_memory_reserved()`` from process start to the window's
end, read before the output check computes anything, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
