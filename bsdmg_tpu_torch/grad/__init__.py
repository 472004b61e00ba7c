from bsdmg_tpu_torch.grad.diff_render import (
    differentiable_hit,
    render_image_diff,
    render_loss_and_grad,
)

__all__ = [
    "differentiable_hit",
    "render_image_diff",
    "render_loss_and_grad",
]
