"""Milliseconds per GAP-TV warm start in the traced window: the length on
the device's timeline of the program's ``apnp.warmstart`` span
(``solvers.gap_tv._gap_tv_packed``), between its own CUDA events, the
time the device waited on the host inside it included."""

from pnpbench.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "apnp.warmstart")
