from halogen_tpu_torch.diff.grad import (
    render_with_materials,
    render_loss,
    render_loss_grad,
    make_optimizer,
    fit_materials,
)

__all__ = [
    "render_with_materials",
    "render_loss",
    "render_loss_grad",
    "make_optimizer",
    "fit_materials",
]
