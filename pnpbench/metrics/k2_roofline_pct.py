"""K2 (``csrc/tv_chambolle.cu``, both designs): the least time of its
launches, the larger of bytes at the HBM peak and operations at the float32
peak, over their device time in the traced window, percent. Each launch
takes the B x 4 packed planes of H/2 x W/2; the operations count the inner
iterations that the reference's warm starts of the checked requests ran per
plane and call (the kernel stops each plane early on its data)."""

from pnpbench.counts import k2


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.tv_iterations is None:
        return None
    n = tr.launches.get("tv_chambolle", 0)
    t = ctx.kernel_s("tv_chambolle")
    if not n or not t:
        return None
    tf = ctx.cell.traffic
    planes, h, w = 4 * tf["frames"], tf["height"] // 2, tf["width"] // 2
    bound = max(k2.bytes_per_launch(planes, h, w) / ctx.peaks["hbm_bytes_per_s"],
                k2.flops_per_launch(planes, h, w, ctx.tv_iterations)
                / ctx.peaks["fp32_flops_per_s"])
    return 100 * n * bound / t
