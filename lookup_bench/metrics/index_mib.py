"""The index's size as the port reports it (``IndexBuild.size_bytes``),
in MiB."""
LAYER = "build and lowering"
UNIT = "MiB"
SOURCE = "program_counter"
MOVES = "device_peak_gib"
BETTER = "lower"


def read(ctx):
    size = ctx.get("index_bytes")
    return None if size is None else size / 2 ** 20
