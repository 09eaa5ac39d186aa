"""The 95th percentile of the traced window's requests, each timed by the
host clock from the call to its boxes and mask on the host (under the
profiler, which adds its own cost to each); at least ten requests lie
beyond it where the window has 200 or more."""

import statistics


def read(ctx):
    lat = ctx.get("latencies_ms") or []
    if ctx["mode"] != "stream" or len(lat) < 200:
        return None
    return statistics.quantiles(lat, n=100)[94]
