"""The share of the traced window in which no operation ran on the device,
percent: one minus the union of the device events' intervals over the
window."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100 * (1 - ctx.busy_s / tr.window_s)
