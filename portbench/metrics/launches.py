"""launches.<kind>: kernel launches a step (frame, fit) in the traced
stretch, as `torch.profiler` counts the host's launch calls."""


def read(trace: dict, variant: str | None):
    if variant not in (None, trace.get("kind")) or trace["launches"] <= 0:
        return None
    return trace["launches"] / trace["steps"]
