"""The least work of the sky backward in a traced stretch of fit steps, and
the least time an H100 could take for it: the yardstick of
`sky_roofline.*`.

Per path that ended at the sky, its colour's cotangent read once (three
float32) and `work.OPS_SKY_BWD` operations (the eight taps' weights and
the per-texel sums); per step, the atlas's gradient written once (three
float32 a texel of every mip). The paths are counted by the plain
reference on a sample of the stretch's own rays, scaled to all of them. A
backward that keeps no atlas a group and sums in registers still needs
this much.
"""

from __future__ import annotations

import torch

from portbench import work
from portbench.reference import tracer as ref_tracer


def sky_backward_work(sky_paths: float, n_texels: int, steps: int) -> dict:
    """Bytes, operations and least seconds of the sky backward of `steps`
    steps whose paths reached the sky `sky_paths` times in all."""
    n_bytes = 12.0 * sky_paths + 12.0 * n_texels * steps
    ops = work.OPS_SKY_BWD * sky_paths
    return {"bytes": n_bytes, "ops": ops,
            "least_s": work.bound_s(n_bytes, ops)}


def traced_sky_work(sc, cam, rst: dict, pixels, frames, lanes,
                    total_rays: int, steps: int) -> dict:
    """`sky_backward_work` of a traced stretch of `total_rays` rays, its
    sky paths counted by the reference on the samples (pixel, frame,
    lane) and scaled to all of them."""
    stats: dict = {}
    with torch.no_grad():
        ref_tracer.sample_colors(sc, cam, rst, pixels, frames, lanes,
                                 stats=stats)
    sky = float(stats.get("sky", 0.0)) * total_rays / pixels.shape[0]
    n_texels = sum(int(m.shape[0]) * int(m.shape[1]) for m in sc.env_mips)
    return dict(sky_backward_work(sky, n_texels, steps), sky_paths=sky)
