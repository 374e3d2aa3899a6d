"""The model step's share of the chip's bf16 peak: the configuration's
model FLOPs an image (``benchmark/counts.py``) times the images of the
traced window, over its length and 989 TFLOP/s, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or "latencies_ms" in vars(ctx) or not t.window_s():
        return None
    flops = ctx.counts.model_flops_per_image(ctx.spec) * ctx.images
    return 100.0 * flops / (t.window_s() * ctx.counts.PEAK_BF16)
