from halogen_tpu_torch.render.accumulate import RenderState, Renderer

__all__ = ["RenderState", "Renderer"]
