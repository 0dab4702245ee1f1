"""device_idle.<kind>: the share of the traced stretch of the kind's steps
(frames, fits) in which no operation ran on the device, from
`torch.profiler`'s device rows."""


def read(trace: dict, variant: str | None):
    if variant not in (None, trace.get("kind")) or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])
