"""Milliseconds per trigger of the online adaptation (its draws, forwards
with a gradient, backwards and Adam steps): the length on the device's
timeline of the program's ``apnp.adapt`` span
(``adapt.online.make_adapt_fn``), the time the device waited on the host
inside it included."""

from pnpbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "apnp.adapt")
