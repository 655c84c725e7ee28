"""The whole snapshot's share of the chip's peak, percent: the model
operations of the window (every prior call's forward, plus three forwards
for each Adam step of the adaptation, counted from the layer shapes) over
the window's seconds times the peak of the configuration's precision
(float32 without TF32: the float32 peak; bfloat16: the bf16 dense peak)."""

from pnpbench.counts import adapt

PEAK = {"float32": "fp32_flops_per_s", "bfloat16": "bf16_flops_per_s"}


def read(ctx):
    spans, model = ctx.spans, ctx.model
    if spans is None or model is None or not spans.apply_calls:
        return None
    tf, cfg = ctx.cell.traffic, ctx.cell.config
    f = model.flops_per_call(cfg, tf["frames"], tf["height"], tf["width"])
    flops = spans.apply_calls * f + adapt.flops(f, spans.adapt_calls)
    return 100 * flops / (ctx.window_s * ctx.peaks[PEAK[cfg["precision"]]])
