"""Milliseconds of device time per Adam step of the online adaptation (a
draw, forwards with a gradient, a backward and the step): the program's
``apnp.adapt`` spans over its ``apnp.adam_steps`` counter, per request. A
trigger's fixed cost (the sampling set-up, the gradients' release) is
spread over its steps."""

from pnpbench.program_spans import ms_per_count


def read(ctx):
    return ms_per_count(ctx, "apnp.adapt", "apnp.adam_steps")
