"""On-device pixel preprocessing (counterpart of the JAX package's
``ops/preprocess.py``): the host ships uint8 NHWC clips and the device
standardizes them (and :func:`denormalize_clip` undoes that for the
reconstruction pictures); the visual-privacy layer blurs face regions
there."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ImageNet statistics (ref: src/datasets/transforms.py:35-36)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_clip(clip_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> ImageNet-standardized float [..., H, W, 3]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=clip_u8.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=clip_u8.device) * 255.0
    x = clip_u8.to(torch.float32)
    return ((x - mean) / std).to(dtype)


def denormalize_clip(clip: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`normalize_clip`: fp32 pixels in [0, 255]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=clip.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=clip.device) * 255.0
    return clip.to(torch.float32) * std + mean


def gaussian_blur_nhwc(img: torch.Tensor, kernel_size: int,
                       sigma: float | None = None) -> torch.Tensor:
    """Separable Gaussian blur on ``[..., H, W, C]`` float images, on their
    device: the replacement for cv2.GaussianBlur in the visual-privacy path
    (ref: src/privacy/visual_mask.py:33-41).

    As the JAX version: an odd kernel (``k | 1``), OpenCV's default sigma
    ``0.3*((k-1)*0.5 - 1) + 0.8``, taps normalized in fp32 then cast to the
    image's dtype, and ZERO padding (``lax.conv_general_dilated``'s, not
    OpenCV's reflection): two depthwise convs, along H then along W.
    """
    k = int(kernel_size) | 1
    if sigma is None or sigma <= 0:
        sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    half = k // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    g = torch.exp(-0.5 * (xs / sigma) ** 2)
    g = (g / g.sum()).to(img.dtype)

    shape = img.shape
    H, W, C = shape[-3:]
    x = img.reshape(-1, H, W, C).permute(0, 3, 1, 2)  # NCHW view
    x = F.conv2d(x, g.view(1, 1, k, 1).expand(C, 1, k, 1), padding=(half, 0), groups=C)
    x = F.conv2d(x, g.view(1, 1, 1, k).expand(C, 1, 1, k), padding=(0, half), groups=C)
    return x.permute(0, 2, 3, 1).reshape(shape)
