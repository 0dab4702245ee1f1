"""sky_roofline.<kind>: the least time an H100 needs for the traced
stretch's sky backward (`portbench/work_sky.py`: a cotangent read a sky
path, its taps' and sums' operations, the atlas's gradient written once a
step) over the sky backward kernels' device time."""


def read(trace: dict, variant: str | None):
    if variant not in (None, trace.get("kind")) or \
            trace.get("sky_least_s") is None or \
            not trace.get("sky_backward_s"):
        return None
    return 100.0 * trace["sky_least_s"] / trace["sky_backward_s"]
