"""Host-side frame transforms (counterpart of the JAX package's
``data/transforms.py``; reference: src/datasets/transforms.py).

The data path keeps frames uint8 until the device (normalization happens
there, ``ops/preprocess.normalize_clip``); these numpy equivalents exist for
host-side consumers (visualization, privacy tooling) and for parity with the
reference's Resize -> ToTensor -> Normalize pipeline.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize to size x size (ref: src/datasets/transforms.py:9-15)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    if cv2 is not None:
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    # numpy fallback: nearest
    ys = (np.arange(size) * img.shape[0] / size).astype(int)
    xs = (np.arange(size) * img.shape[1] / size).astype(int)
    return img[ys][:, xs]


def to_float(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> float32 in [0, 1] (channel-last, unlike torch)."""
    return img.astype(np.float32) / 255.0


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    return (img - mean) / std


def build_transforms(image_size: int):
    """Resize -> scale -> ImageNet-normalize composition
    (ref: src/datasets/transforms.py:34-42)."""
    def apply(img: np.ndarray) -> np.ndarray:
        return normalize(to_float(resize(img, image_size)))
    return apply
