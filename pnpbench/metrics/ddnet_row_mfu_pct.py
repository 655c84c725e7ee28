"""The whole snapshot's share of the chip's peak in the deep-demosaicking
row, percent: :mod:`snapshot_mfu_pct` (the prior's forwards and the
adaptation's over the window, at the configuration's peak) plus DDnet's
operations over the same window at the demosaicker's peak. DDnet's: its
forward on each window of the program's ``apnp.ddnet_windows`` counter per
``apnp.prior`` call of the traced requests, times the window's prior calls,
counted from the layer shapes. Nothing is read from a program without that
counter."""

from pnpbench.counts import ddnet
from pnpbench.metrics import snapshot_mfu_pct
from pnpbench.program_spans import in_window


def read(ctx):
    base = snapshot_mfu_pct.read(ctx)
    spans = in_window(ctx)
    requests = {s.request: s.counters for s in spans if s.parent == -1}
    windows = sum(c.get("apnp.ddnet_windows", 0) for c in requests.values())
    calls = sum(1 for s in spans if s.name == "apnp.prior" and s.request in requests)
    if base is None or not windows or not calls:
        return None
    dm, tf = ctx.cell.config["demosaicker"], ctx.cell.traffic
    per_window = ddnet.flops_per_window(-(-tf["height"] // 4) * 4, -(-tf["width"] // 4) * 4,
                                        tuple(dm["channels"]))
    flops = ctx.spans.apply_calls * windows / calls * per_window
    return base + 100 * flops / (ctx.window_s * ctx.peaks[snapshot_mfu_pct.PEAK[dm["precision"]]])
