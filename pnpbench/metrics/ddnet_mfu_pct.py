"""DDnet's share of the chip's peak, percent: its operations per window
(``counts/ddnet.py``, from the layer shapes at the padded frame size) over
the device milliseconds of the program's ``apnp.ddnet`` spans per window of
its ``apnp.ddnet_windows`` counter, at the peak of the demosaicker's
precision. DDnet's convolutions run on the library's kernels (cuDNN), so
this is their share of the roofline, the elementwise work between them in
the time and not in the operations."""

from pnpbench.counts import ddnet
from pnpbench.metrics.snapshot_mfu_pct import PEAK
from pnpbench.program_spans import ms_per_count


def read(ctx):
    ms = ms_per_count(ctx, "apnp.ddnet", "apnp.ddnet_windows")
    if not ms:
        return None
    dm, tf = ctx.cell.config["demosaicker"], ctx.cell.traffic
    h, w = -(-tf["height"] // 4) * 4, -(-tf["width"] // 4) * 4
    flops = ddnet.flops_per_window(h, w, tuple(dm["channels"]))
    return 100 * flops / (ms / 1e3 * ctx.peaks[PEAK[dm["precision"]]])
