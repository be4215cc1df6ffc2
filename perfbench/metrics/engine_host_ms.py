"""Host milliseconds a step of ``LibraEngine.step`` spends outside the
model's calls: the window's step spans less its ``model.prefill`` and
``model.decode_step`` spans (each ending when the device has finished the
call), over its steps."""


def read(ctx):
    steps = ctx.steps
    if not steps:
        return None
    outside = sum((st.t1 - st.t0) - st.prefill_s - st.decode_s for st in steps)
    return 1e3 * outside / len(steps)
