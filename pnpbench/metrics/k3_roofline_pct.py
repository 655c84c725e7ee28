"""K3 (the conv pair, ``csrc/convpair_wgmma.cu`` and ``csrc/convpair.cu``):
the least time of its launches, the larger of operations at the bf16 dense
peak and bytes at the HBM peak, over their device time in the traced window,
percent. Launches are counted by activation shape ``(C, H, W)`` by the
program; each carries the traffic's B frames (every DenBlock of the prior
runs over one snapshot's frames in one batch)."""

from pnpbench.counts import k3


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.convpair_launches:
        return None
    t = ctx.kernel_s("convpair")
    if not t:
        return None
    b = ctx.cell.traffic["frames"]
    bound = sum(n * max(k3.flops_per_launch(b, h, w, c) / ctx.peaks["bf16_flops_per_s"],
                        k3.bytes_per_launch(b, h, w, c) / ctx.peaks["hbm_bytes_per_s"])
                for (c, h, w), n in tr.convpair_launches.items())
    return 100 * bound / t
