"""Median, over every cold invocation of the window that came back in it,
of the time from its submission to its answer, in ms; a failed one counts
as missing every limit. Each went to a new node, whose start and stop lie
outside that span."""
from harness import readers, stats


def read(ctx):
    lat = [readers.INF if v["failed"] else v["done"] - v["sent"] for v in readers.window(ctx)
           if v["failed"] or v["done"] <= ctx["seconds"]]
    return stats.quantile(lat, 0.5) * 1e3 if lat else None
