"""kernel_roofline.<kind>: the least time an H100 needs for the traced
stretch's work (`portbench/work.py`, counted by the reference on the
stretch's own rays) over the device's busy time in it."""


def read(trace: dict, variant: str | None):
    if variant not in (None, trace.get("kind")) or trace["busy_s"] <= 0:
        return None
    return 100.0 * trace["work"]["least_s"] / trace["busy_s"]
