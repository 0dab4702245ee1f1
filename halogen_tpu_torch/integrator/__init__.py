from halogen_tpu_torch.integrator.camera import Camera, make_camera, generate_rays
from halogen_tpu_torch.integrator.trace import render_frame, trace_rays

__all__ = ["Camera", "make_camera", "generate_rays", "render_frame", "trace_rays"]
