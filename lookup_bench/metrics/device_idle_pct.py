"""Share of the traced window in which no kernel, copy or fill ran on the
card, in percent."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lookups_per_s"
BETTER = "lower"


def read(ctx):
    trace = ctx.get("trace", {})
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
