"""Bytes that cross the host-device boundary per output token: the
engine's ``EngineStats.h2d_bytes`` and ``d2h_bytes`` over the window, over
the tokens emitted in it (the paper's claim: only ids and metadata
cross)."""


def read(ctx):
    if not ctx.tokens:
        return None
    return ctx.boundary_bytes / ctx.tokens
