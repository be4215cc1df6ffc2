"""Work counts: the operations and bytes that a kernel's or a step's inputs
need, from shapes and real lengths, with no padding and no capacity slots.
``work/<kernel>.py`` names the kernel it counts by ``KERNEL``, a part of
the name the profiler prints, and gives ``launches(ctx)``: one
``(flops, bytes)`` for each launch of the profiled window
(``ctx.trace_steps``), in order."""
