"""Milliseconds per call of the deep demosaicker: the length on the
device's timeline of the program's ``apnp.ddnet`` span (one DDnet forward
on the B windows of a demosaic step), the time the device waited on the
host inside it included."""

from pnpbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "apnp.ddnet")
