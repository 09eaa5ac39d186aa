"""What the per-layer readers share: a traced window's numbers that
exist only where the device ran something."""


def traced_device(ctx) -> bool:
    """Whether the traced window saw the device run anything."""
    return ctx["window"].busy_s > 0 and ctx["units"] > 0


def idle_percent(ctx, mode: str):
    if ctx["mode"] != mode or not traced_device(ctx):
        return None
    w = ctx["window"]
    return 100.0 * (1.0 - w.busy_s / w.window_s)


def per_unit(ctx, mode: str, value):
    if ctx["mode"] != mode or not traced_device(ctx):
        return None
    return value / ctx["units"]


def mfu_percent(ctx, mode: str):
    """The window's analytic model FLOPs over its length, as a share of
    the card's dense bfloat16 peak."""
    if ctx["mode"] != mode or not traced_device(ctx):
        return None
    done = ctx["flops_per_image"] * ctx["images_per_unit"] * ctx["units"]
    return 100.0 * done / ctx["window"].window_s / ctx["peak"]["bf16_flops"]
