"""Seconds the port takes to build, lower and compile the index: host
clock around ``core.spec.build``, ``core.plan.lower`` and the first
``LookupPlan.compile("cuda")`` (RMI's float32 refit), ending in a
synchronize."""
LAYER = "build and lowering"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"
BETTER = "lower"


def read(ctx):
    return ctx.get("build_s")
