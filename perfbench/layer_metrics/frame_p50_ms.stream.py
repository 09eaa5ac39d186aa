"""The median of the traced window's requests, each timed by the host
clock from the call to its boxes and mask on the host (under the
profiler, which adds its own cost to each)."""

import statistics


def read(ctx):
    lat = ctx.get("latencies_ms") or []
    return statistics.median(lat) if ctx["mode"] == "stream" and lat else None
