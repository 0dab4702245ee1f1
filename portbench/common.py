"""What the entries share: a cell's inputs made from the seed, the
reference built from the same inputs, the device's record, and the work
count of a traced stretch."""

from __future__ import annotations

import torch

from portbench import work
from portbench.reference import camera as ref_camera
from portbench.reference import scene as ref_scene
from portbench.reference import tracer as ref_tracer
from portbench.scenes import build


def settings(cell) -> dict:
    """The `RenderSettings` fields of the cell: its configuration's, with
    its traffic's on top."""
    return {**cell.config["settings"], **cell.traffic.get("settings", {})}


def inputs(cell, seed: int, device):
    """(objects, camera spec, sky image or None) of the cell, from the
    frozen scene and `seed`."""
    objects, cam = build.load(cell.config["scene"])
    env = cell.config.get("envmap")
    image = (build.procedural_hdri(env["width"], seed, device)
             if env else None)
    return objects, cam, image


def reference(cell, objects, cam_spec, image, st: dict, device):
    """(scene, camera, settings) of the plain reference."""
    sc = ref_scene.build_scene(objects, device, image, env_mips(cell))
    rst = ref_tracer.settings(st)
    return sc, ref_camera.make_camera(
        cam_spec, st["width"] / st["height"], device), rst


def lane_block(st: dict) -> int:
    """Lanes of a pixel the port traces as one group in this cell
    (`render_pixels`' grouping, which a frame's sums follow)."""
    rays = st.get("ray_chunk_size", 65536)  # RenderSettings' default
    return ref_tracer.lane_block(min(rays, st["width"] * st["height"]),
                                 st["samples_per_pixel"], rays)


def env_mips(cell) -> int:
    return int(cell.config.get("envmap", {}).get("mips", 6))


def device_record(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def scene_bytes(sc) -> int:
    """Bytes of the tables a renderer reads once a step: triangles (12
    floats of position and 12 of normals a row, as the kernels keep
    them), spheres, materials and the sky's mips."""
    n = sc.num_triangles * 24 * 4 + sc.num_spheres * 16
    n += sum(t.numel() * t.element_size() for t in sc.materials.values())
    n += sum(m.numel() * m.element_size() for m in sc.env_mips)
    return n


def traced_work(sc, cam, rst: dict, pixels, frames, lanes, total_rays: int,
                out_bytes: float, steps: int, backward: bool) -> dict:
    """`work.stretch_work` of a traced stretch from a sample of its
    (pixel, frame, lane) samples traced by the reference."""
    stats: dict = {}
    with torch.no_grad():
        ref_tracer.sample_colors(sc, cam, rst, pixels, frames, lanes,
                                 stats=stats)
    counts = {k: float(v) for k, v in stats.items()}
    counts.setdefault("sky", 0.0)
    counts["rays"] = float(pixels.shape[0])
    return work.stretch_work(
        counts, total_rays, steps * scene_bytes(sc), steps * out_bytes,
        glass=sc.any_transmissive, backward=backward,
        primitives=sc.num_triangles + sc.num_spheres)
