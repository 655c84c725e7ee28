"""Milliseconds per ADMM iteration outside its demosaic, adaptation and
prior: the program's ``apnp.admm.iter`` span less the ``apnp.demosaic``,
``apnp.adapt`` and ``apnp.prior`` spans inside it, lengths on the device's
timeline (the time the device waited on the host included). It holds the
x-update (K1), the dual updates, the clamps and the subsampling."""

from pnpbench.program_spans import mean_self_ms


def read(ctx):
    return mean_self_ms(ctx, "apnp.admm.iter")
