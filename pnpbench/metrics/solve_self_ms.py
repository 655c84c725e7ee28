"""Milliseconds per request that the solve's entry spends outside its warm
start and its ADMM iterations: the program's ``apnp.solve`` span less the
spans opened directly inside it, lengths on the device's timeline. It holds
the measurement's copy to the device, the packing, the adjoint, the solve
state's copy of the weights and the unpacking, and the time the device
waited on the host for them: most of it where the host is slow to launch."""

from pnpbench.program_spans import mean_self_ms


def read(ctx):
    return mean_self_ms(ctx, "apnp.solve")
