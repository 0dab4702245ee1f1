from halogen_tpu_torch.parallel.sharding import (
    init_distributed,
    loss_and_grads_sharded,
    make_render_mesh,
    render_frame_sharded,
    train_step_sharded,
)

__all__ = [
    "make_render_mesh",
    "render_frame_sharded",
    "loss_and_grads_sharded",
    "train_step_sharded",
    "init_distributed",
]
