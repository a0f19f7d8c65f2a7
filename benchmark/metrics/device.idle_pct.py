"""device.idle_pct: share of the traced window in which no kernel, copy or
fill ran on the card, from the profiler's device timeline, in %."""


def read(ctx):
    s = ctx["summary"]
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
