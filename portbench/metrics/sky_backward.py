"""sky_backward.<kind>: the sky backward kernels' device time (the taps,
the radix ordering's passes, the per-texel sums) over the device's busy
time in the traced stretch; only where the entry times them (`fit_sky`)."""


def read(trace: dict, variant: str | None):
    if variant not in (None, trace.get("kind")) or trace["busy_s"] <= 0 \
            or trace.get("sky_backward_s") is None:
        return None
    return 100.0 * trace["sky_backward_s"] / trace["busy_s"]
