"""Device time of the program's attention kernel over the packed KV
cache's value codes (A1, by its kernel's name) in the traced window, per
image.  Nothing is read where the trace shows no such kernel: a dense
cache, or a program that runs that attention as a chain of library
kernels."""

#: A1's kernel name, a part of its name in the device trace
KEYS = ("packed_attention_kernel",)


def read(ctx):
    t = ctx.trace
    if t is None or "latencies_ms" in vars(ctx) or not ctx.images:
        return None
    if not t.launches(KEYS):
        return None
    return t.kernel_s(KEYS) * 1e3 / ctx.images
