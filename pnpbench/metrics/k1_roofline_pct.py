"""K1 (``csrc/x_update.cu``): the least time of its launches by bytes at the
HBM peak, over their device time in the traced window, percent. Every
launch of these cells is one packed cube of the traffic's B frames."""

from pnpbench.counts import k1


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n = tr.launches.get("x_update", 0)
    t = ctx.kernel_s("x_update")
    if not n or not t:
        return None
    tf = ctx.cell.traffic
    bound = k1.bytes_per_launch(tf["frames"], tf["height"], tf["width"]) / ctx.peaks["hbm_bytes_per_s"]
    return 100 * n * bound / t
