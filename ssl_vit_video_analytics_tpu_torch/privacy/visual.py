"""Visual privacy: face detection + ROI anonymization (counterpart of the JAX
package's ``privacy/visual.py``).

Detection stays a host-side OpenCV step: YuNet is an ONNX model run by
cv2's DNN runtime on CPU images, one image at a time
(ref: src/privacy/visual_mask.py:5-22). The blur runs on the anonymizer's
device, a separable Gaussian over the whole frame
(``ops.preprocess.gaussian_blur_nhwc``) blended in by the face-box mask.

A deterministic ``StubFaceDetector`` keeps tests and machines without
YuNet (no weights, or a cv2 without ``FaceDetectorYN``) runnable; the
reference downloads the weights at runtime (ref: src/run_privacy.py:56-71),
which an offline machine cannot.
"""
from __future__ import annotations

import os

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..ops.preprocess import gaussian_blur_nhwc


class YuNetFaceDetector:
    """cv2.FaceDetectorYN wrapper (ref: src/privacy/visual_mask.py:5-22)."""

    def __init__(self, model_path: str, conf_th: float = 0.6, nms_th: float = 0.3,
                 top_k: int = 5000):
        if cv2 is None or not hasattr(cv2, "FaceDetectorYN"):
            raise RuntimeError("cv2.FaceDetectorYN unavailable")
        if not os.path.exists(model_path):
            raise FileNotFoundError(f"YuNet model not found: {model_path}")
        self.detector = cv2.FaceDetectorYN.create(model_path, "", (320, 320),
                                                  conf_th, nms_th, top_k)

    def detect(self, img: np.ndarray) -> np.ndarray:
        """BGR/RGB uint8 [H, W, 3] -> int [N, 4] (x, y, w, h) boxes."""
        h, w = img.shape[:2]
        self.detector.setInputSize((w, h))
        _, faces = self.detector.detect(img)
        if faces is None:
            return np.zeros((0, 4), dtype=int)
        return faces[:, :4].astype(int)


class StubFaceDetector:
    """Deterministic center-box detector for tests / environments without
    YuNet weights. Always reports one face covering the central third."""

    def detect(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        return np.array([[w // 3, h // 3, w // 3, h // 3]], dtype=int)


def make_detector(model_path: str | None, conf_th: float = 0.6, nms_th: float = 0.3):
    if model_path and os.path.exists(model_path) and cv2 is not None \
            and hasattr(cv2, "FaceDetectorYN"):
        return YuNetFaceDetector(model_path, conf_th, nms_th)
    return StubFaceDetector()


def boxes_to_mask(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    """[N, 4] (x, y, w, h) -> float [H, W, 1] mask, 1 inside any face box."""
    mask = np.zeros((h, w, 1), dtype=np.float32)
    for (x, y, bw, bh) in boxes:
        x0, y0 = max(int(x), 0), max(int(y), 0)
        x1, y1 = min(int(x + bw), w), min(int(y + bh), h)
        if x1 > x0 and y1 > y0:
            mask[y0:y1, x0:x1, :] = 1.0
    return mask


class VisualAnonymizer:
    """Detect faces on the host, Gaussian-blur their ROIs on ``device``.

    ``apply`` matches the reference's contract: (anonymized_img, n_faces)
    (ref: src/privacy/visual_mask.py:25-42). The blend is clipped to
    [0, 255] and cast back to the image's dtype by truncation, as the JAX
    package's ``astype``.
    """

    def __init__(self, detector, method: str = "face_blur", blur_kernel: int = 31,
                 device: str | torch.device = "cuda"):
        self.detector = detector
        self.method = method
        self.blur_kernel = blur_kernel if blur_kernel % 2 == 1 else blur_kernel + 1
        self.device = torch.device(device)

    def _blend(self, imgs: np.ndarray, masks: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(imgs).to(self.device, torch.float32)
        m = torch.from_numpy(masks).to(self.device)
        out = x * (1.0 - m) + gaussian_blur_nhwc(x, self.blur_kernel) * m
        return out.clamp(0, 255).cpu().numpy().astype(imgs.dtype)

    def apply(self, img: np.ndarray) -> tuple[np.ndarray, int]:
        boxes = self.detector.detect(img)
        if len(boxes) == 0:
            return img.copy(), 0
        h, w = img.shape[:2]
        return self._blend(img, boxes_to_mask(boxes, h, w)), len(boxes)

    def apply_batch(self, imgs: np.ndarray) -> tuple[np.ndarray, list[int]]:
        """Batched variant: one device blur for the whole stack of frames."""
        n, h, w, _ = imgs.shape
        masks = np.zeros((n, h, w, 1), dtype=np.float32)
        counts = []
        for i in range(n):
            boxes = self.detector.detect(imgs[i])
            counts.append(len(boxes))
            if len(boxes):
                masks[i] = boxes_to_mask(boxes, h, w)
        return self._blend(imgs, masks), counts
