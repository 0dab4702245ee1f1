"""The least work a correct renderer needs for a stretch of frames or fit
steps, and the least time an H100 could take for it: the yardstick of the
`kernel_roofline.*` metrics.

The work is counted by the plain reference on a sample of the stretch's
own rays, scaled to all of them: one primitive test per ray-bounce
intersection, the shading (and, for a fit, the adjoint's sweep) of each
shaded bounce, a primary ray made per sample, the sky's lookup (and its
backward) per path that ended at the sky, the scene's tables read once and
the image (and gradients) written once. A renderer that tests fewer
primitives or keeps no record still needs this much, so the share cannot
pass 100% unless the time leaves work out. The full scan's count, every
primitive tested at every intersection, is kept beside it
(`full_scan_ops`) as a diagnostic.

The operation counts of one primitive test, one shaded bounce and so on
are those of `chip_smoke.py` (counted from the port's CUDA sources); an
int32 operation counts as two fp32 ones.
"""

from __future__ import annotations

OPS_TRI, OPS_SPHERE = 55, 55
OPS_SHADE = 230  # an opaque hit: normals, draws, Fresnel, lobes, RR
OPS_GLASS = 50  # + the refraction branch and Beer-Lambert
OPS_SWEEP = 60  # the adjoint's sweep of a shaded bounce
OPS_RAY = 90  # a primary ray (camera_ray; logf x 2)
OPS_SKY = 200  # a path's sky lookup
OPS_SKY_BWD = 150  # its backward taps and sums
OPS_INT_SHADE = 2 * 71 + 31  # a shaded bounce: two 2D Sobol draws, one 1D
OPS_INT_RAY = 2 * 71 + 12  # a primary ray: two 2D draws, seed and index
# H100 SXM published peaks: fp32 outside the tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def bound_s(n_bytes: float, ops: float) -> float:
    """The least seconds of the work: the larger of its bytes over the
    peak memory rate and its fp32 operations over the peak fp32 rate."""
    return max(n_bytes / PEAK_BYTES, ops / PEAK_FLOPS)


def path_ops(rays: float, isect: float, shaded: float, sky: float,
             glass: bool, backward: bool, tests_per_isect: float = 1.0
             ) -> float:
    """fp32-equivalent operations of the counted work."""
    shade = OPS_SHADE + (OPS_GLASS if glass else 0) + (
        OPS_SWEEP if backward else 0)
    return (rays * (OPS_RAY + 2 * OPS_INT_RAY)
            + isect * tests_per_isect * OPS_TRI
            + shaded * (shade + 2 * OPS_INT_SHADE)
            + sky * (OPS_SKY + (OPS_SKY_BWD if backward else 0)))


def stretch_work(counts: dict, total_rays: float, scene_bytes: float,
                 out_bytes: float, glass: bool, backward: bool,
                 primitives: int) -> dict:
    """Least and full-scan work of a stretch of `total_rays` rays, from
    `counts` (rays, isect, shaded, sky) on a sample of them; the tables and
    outputs are read and written once per step, so the caller gives their
    bytes summed over the stretch's steps."""
    k = total_rays / counts["rays"]
    isect, shaded, sky = (k * counts[n] for n in ("isect", "shaded", "sky"))
    least = path_ops(total_rays, isect, shaded, sky, glass, backward)
    full = path_ops(total_rays, isect, shaded, sky, glass, backward,
                    tests_per_isect=primitives)
    n_bytes = scene_bytes + out_bytes
    return {"ops": least, "bytes": n_bytes, "full_scan_ops": full,
            "least_s": bound_s(n_bytes, least),
            "full_scan_s": bound_s(n_bytes, full)}
