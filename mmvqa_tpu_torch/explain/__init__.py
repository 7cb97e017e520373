from mmvqa_tpu_torch.explain.cam_zoo import CAM_METHODS
from mmvqa_tpu_torch.explain.gradcam import (
    grad_cam_activations,
    grad_cam_heatmap,
    overlay_heatmap,
)

__all__ = [
    "grad_cam_activations",
    "grad_cam_heatmap",
    "overlay_heatmap",
    "CAM_METHODS",
]
