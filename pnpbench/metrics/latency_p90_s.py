"""The 90th percentile of every request's time in the window, from the
hand-over of the measurement to the reconstruction on the host
(``statistics.quantiles``, inclusive method)."""

import statistics


def read(ctx):
    lat = ctx.latencies
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0]
    return statistics.quantiles(lat, n=10, method="inclusive")[-1]
