"""Bytes of the tensors of ``VARGenerator.init_cache(batch)``, in GiB."""


def read(ctx):
    return ctx.kv_bytes / 2 ** 30 if ctx.kv_bytes else None
