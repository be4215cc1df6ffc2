"""Milliseconds a ``TransformerLM.decode_step`` call takes, from its call
until its tokens can be downloaded, over the window's decode calls."""


def read(ctx):
    calls = [st.decode_s for st in ctx.steps if st.decode_ctx]
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
