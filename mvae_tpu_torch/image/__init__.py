"""Image transforms of the vision family (the port's copy of
mvae_tpu/image/)."""

from mvae_tpu_torch.image.transforms import (
    alpha_composite, canny_edges, landmark_mask, load_watermark,
    make_watermark, obscure, rgb_to_grayscale)

__all__ = ["alpha_composite", "canny_edges", "landmark_mask",
           "load_watermark", "make_watermark", "obscure",
           "rgb_to_grayscale"]
