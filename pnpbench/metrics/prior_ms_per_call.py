"""Milliseconds of device time per call of the prior's ``apply`` in the
window: CUDA events recorded by the benchmark before and after each call
(the adaptation's forwards are not in the span)."""


def read(ctx):
    spans = ctx.spans
    if spans is None or not spans.apply_ms:
        return None
    return sum(spans.apply_ms) / len(spans.apply_ms)
