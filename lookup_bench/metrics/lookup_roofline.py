"""The lookup kernels' share of their roofline: the least time the card
could take to move the traced batches' least bytes
(`lookup_bench.roofline.batch_bytes`), over the device time of all
kernels in the traced window, in percent.  Nothing where the trace holds
no kernel or the table no peak for the card."""
from lookup_bench import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lookups_per_s"
BETTER = "higher"


def read(ctx):
    kernel_s = ctx.get("trace", {}).get("kernel_s")
    least = roofline.least_seconds(ctx.get("traced_bytes", 0), ctx["kind"])
    if not kernel_s or not least:
        return None
    return 100.0 * least / kernel_s
