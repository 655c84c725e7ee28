"""Milliseconds per demosaic step of an ADMM iteration: the length on the
device's timeline of the program's ``apnp.demosaic`` span, the time the
device waited on the host inside it included."""

from pnpbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "apnp.demosaic")
