"""The HDRI frame's parting rays through the JAX package's lockstep, on the
CPU.

Reads the JSON that `perf/torch/hdri_parting.py` wrote on the card (the
rays of the pixels where the kernel's path and the plain path part, with
their exact bits, and both colors), traces the same rays through the JAX
package's jitted lockstep (`halogen_tpu.integrator.trace.trace_rays`,
brute-force hits, its own `meshes.outdoors_scene` under its own
`hdr_io.procedural_hdri(2048)`) and through the port's lockstep on the
CPU, and says for each ray which of the card's two colors the JAX color
is closer to. Like the tests, it runs the JAX package on the CPU only.

    python perf/torch/hdri_parting_jax.py chiprun_out/hdri_parting.json
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def main(argv=None) -> dict:
    path = (argv or sys.argv[1:] or ["chiprun_out/hdri_parting.json"])[0]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    import halogen_tpu as jht
    from halogen_tpu.config import Intersector as JIntersector
    from halogen_tpu.integrator.trace import trace_rays as j_trace_rays
    from halogen_tpu.scene import hdr_io as jhdr
    from halogen_tpu.scene import meshes as jmeshes
    from halogen_tpu.scene.envmap import Envmap as JEnvmap

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.integrator.trace import deferred_sky
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.scene import hdr_io, meshes

    data = json.loads(pathlib.Path(path).read_text())
    rays = data["apart"]
    if not rays:
        print(json.dumps(dict(rays=0)))
        return {}
    o = np.array([r["origin"] for r in rays], np.float32)
    d = np.array([r["direction"] for r in rays], np.float32)
    sidx = np.array([r["sample_idx"] for r in rays], np.uint32)
    seed = np.array([r["seed"] for r in rays], np.uint32)
    k_col = np.array([r["color_kernel"] for r in rays], np.float32)
    p_col = np.array([r["color_plain"] for r in rays], np.float32)

    hdri = jhdr.procedural_hdri(2048)
    js = jmeshes.outdoors_scene().build(
        envmap=JEnvmap.from_equirect(hdri, num_mips=6))
    jcam = jht.make_camera(**data["camera"])
    jst = jht.RenderSettings(**data["settings"],
                             intersector=JIntersector.BRUTE)
    far = float(np.asarray(jcam.far))
    trace = jax.jit(lambda o, d, s, e: j_trace_rays(
        js, o, d, jnp.full((o.shape[0],), far, jnp.float32), s, e,
        jst).color)
    j_col = np.asarray(trace(jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(sidx), jnp.asarray(seed)))

    env = ht.Envmap.from_equirect(hdr_io.procedural_hdri(2048), num_mips=6)
    ts = meshes.outdoors_scene().build(envmap=env, device="cpu")
    tst = ht.RenderSettings(**data["settings"])
    t_col = deferred_sky(ts, tst, mk.trace_color_fused_reference(
        ts, torch.from_numpy(o), torch.from_numpy(d), torch.tensor(far),
        torch.from_numpy(sidx.astype(np.int64)),
        torch.from_numpy(seed.astype(np.int64)), tst)).numpy()

    def rel(a, b):
        return np.abs(a - b).max(axis=1) / (np.abs(b).max(axis=1) + 1e-6)

    to_k, to_p = rel(j_col, k_col), rel(j_col, p_col)
    cpu_to_p, cpu_to_j = rel(t_col, p_col), rel(t_col, j_col)
    res = dict(
        device_of_rays=data["device"], rays=len(rays),
        jax_closer_to_kernel=int((to_k < to_p).sum()),
        jax_closer_to_plain=int((to_p < to_k).sum()),
        jax_within_1e4_of_kernel=int((to_k <= 1e-4).sum()),
        jax_within_1e4_of_plain=int((to_p <= 1e-4).sum()),
        port_cpu_within_1e4_of_card_plain=int((cpu_to_p <= 1e-4).sum()),
        port_cpu_within_1e4_of_jax=int((cpu_to_j <= 1e-4).sum()),
        median_rel_jax_to_kernel=float(np.median(to_k)),
        median_rel_jax_to_plain=float(np.median(to_p)),
        per_ray=[dict(ray=r["ray"], first_apart=r["first_apart"],
                      jax_to_kernel=float(a), jax_to_plain=float(b),
                      cpu_to_plain=float(c))
                 for r, a, b, c in zip(rays, to_k, to_p, cpu_to_p)])
    print(json.dumps({k: v for k, v in res.items() if k != "per_ray"}))
    return res


if __name__ == "__main__":
    main()
