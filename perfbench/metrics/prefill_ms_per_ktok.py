"""Milliseconds of ``TransformerLM.prefill`` calls (each until its first
tokens can be downloaded) per thousand real prompt tokens, over the
window's prefills; the group's padding is not counted as tokens."""


def read(ctx):
    secs = sum(st.prefill_s for st in ctx.steps if st.prefill_lens)
    toks = sum(sum(st.prefill_lens) for st in ctx.steps)
    if not toks:
        return None
    return 1e3 * secs / (toks / 1e3)
