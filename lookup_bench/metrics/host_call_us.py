"""Host microseconds a call of the compiled lookup takes to return (its
enqueue): all call time over all calls of the untraced window."""
LAYER = "caller dispatch"
UNIT = "us"
SOURCE = "host_clock"
MOVES = "lookups_per_s"
BETTER = "lower"


def read(ctx):
    calls = ctx.get("calls", 0)
    return ctx["call_s"] / calls * 1e6 if calls else None
