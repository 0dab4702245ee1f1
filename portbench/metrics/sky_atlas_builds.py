"""sky_atlas_builds.<kind>: the copies of the sky's mips into an atlas a
step in the traced stretch, by the program's counter `sky.atlas_builds`
(none where the program has no such counter)."""


def read(trace: dict, variant: str | None):
    if variant not in (None, trace.get("kind")):
        return None
    return trace.get("sky_atlas_builds")
