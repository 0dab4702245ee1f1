from halogen_tpu_torch.utils.metrics import RaysMeter, RenderStats, get_logger
