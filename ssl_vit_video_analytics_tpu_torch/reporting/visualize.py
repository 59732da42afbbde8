"""Training-time visualization hooks (counterpart of the JAX package's
``reporting/visualize.py``).

- ``save_mae_vis``: every-N-epoch token-mask grid + masked-token error
  heatmap PNGs for pipeline C (ref: src/mae/visualize.py:10-84). Gracefully
  no-ops without matplotlib (ref: :19-24).
- ``save_reconstruction_triptych``: pipeline-B orig|masked|recon frame strips
  (ref: src/visualize_mae.py:195-210).

Both run the model's forward under ``torch.no_grad()`` in eval mode on the
model's device (the attention through ``ops/attention.py``: K1 on a card),
and put the model back in the mode it was in. The array work
(:func:`mae_vis_arrays`, :func:`triptych_arrays`) is apart from the PNG
writing. ``save_mae_vis`` draws its mask from a ``torch.Generator`` seeded
with the epoch, where JAX draws from ``jax.random.key(epoch)``: the same law,
other numbers.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # pragma: no cover
    plt = None

from ..data.masking import make_token_mask
from ..ops.patchify import patchify, unpatchify
from ..ops.preprocess import denormalize_clip, normalize_clip


@contextlib.contextmanager
def _inference(model: torch.nn.Module):
    """``model`` in eval mode without autograd; its mode restored after."""
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def mae_vis_arrays(model, clip_u8: np.ndarray, epoch: int, tokens_per_frame: int,
                   mask_ratio: float, mask_mode: str, dtype: torch.dtype
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Pipeline C's one-clip picture: the token mask drawn for ``epoch`` and
    each token's mean squared reconstruction error, both ``[T, P]``."""
    device = _device(model)
    T = clip_u8.shape[0]
    gen = torch.Generator(device=device).manual_seed(int(epoch))
    mask = make_token_mask(gen, 1, T, tokens_per_frame, mask_ratio, mask_mode, device)
    clip = normalize_clip(torch.from_numpy(np.asarray(clip_u8)[None]).to(device), dtype=dtype)
    with _inference(model):
        rec, target = model(clip, mask)
    err = ((rec.float() - target.float()) ** 2).mean(dim=-1)[0]
    return (mask[0].cpu().numpy().reshape(T, tokens_per_frame),
            err.cpu().numpy().reshape(T, tokens_per_frame))


def save_mae_vis(model, ds, out_dir: str, epoch: int, tokens_per_frame: int,
                 mask_ratio: float, mask_mode: str, dtype: torch.dtype) -> str | None:
    """One-sample mask grid [T, P] + per-token reconstruction-error heatmap
    of ``ds``'s first clip, to ``out_dir/vis/mae_vis_epoch_{epoch}.png``."""
    if plt is None:
        return None
    mask_np, err_np = mae_vis_arrays(model, ds.get_clip(0), epoch, tokens_per_frame,
                                     mask_ratio, mask_mode, dtype)

    ensure = os.path.join(out_dir, "vis")
    os.makedirs(ensure, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].imshow(mask_np, aspect="auto", cmap="gray_r", interpolation="nearest")
    axes[0].set_title(f"token mask (ep {epoch}, ratio {mask_ratio:.2f}, {mask_mode})")
    axes[0].set_xlabel("token")
    axes[0].set_ylabel("frame")
    im = axes[1].imshow(err_np * mask_np, aspect="auto", cmap="magma", interpolation="nearest")
    axes[1].set_title("masked-token error")
    fig.colorbar(im, ax=axes[1])
    path = os.path.join(ensure, f"mae_vis_epoch_{epoch}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def triptych_arrays(model, clip_u8: np.ndarray, mask: torch.Tensor, patch_size: int,
                    dtype: torch.dtype, norm_pix: bool = False
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pipeline B's orig, masked and recon clips, uint8 ``[T, H, W, 3]``.

    With ``norm_pix`` the decoder predicts per-patch standardized pixels
    (train/losses.py norm-pix targets), so predictions are un-standardized
    with the ground-truth patch mean and variance (eps 1e-6) before
    unpatchify — the standard MAE visualization convention. ``mask``
    ``[1, T, L]`` bool, True = masked."""
    device = _device(model)
    clip = normalize_clip(torch.from_numpy(np.asarray(clip_u8)[None]).to(device), dtype=dtype)
    B, T, H, W, C = clip.shape
    mask = torch.as_tensor(mask).to(device)
    with _inference(model):
        pred = model(clip, mask).float()
    if norm_pix:
        tgt = patchify(clip.float(), patch_size)
        mean = tgt.mean(dim=-1, keepdim=True)
        var = tgt.var(dim=-1, keepdim=True, unbiased=False)
        pred = pred * torch.sqrt(var + 1e-6) + mean
    recon = denormalize_clip(unpatchify(pred, patch_size, T, H, W))
    recon_np = np.clip(recon.cpu().numpy()[0], 0, 255).astype(np.uint8)

    gh = H // patch_size
    mask_img = mask.cpu().numpy()[0].reshape(T, gh, gh)
    mask_up = np.kron(mask_img, np.ones((patch_size, patch_size)))[..., None]
    masked_np = (clip_u8 * (1 - mask_up)).astype(np.uint8)
    # MAE-paper convention: paste VISIBLE patches from the input — the loss
    # is masked-only, so predictions at visible positions are untrained
    # (visibly garbage under raw-pixel loss) and not part of the pretext
    recon_np = (clip_u8 * (1 - mask_up) + recon_np * mask_up).astype(np.uint8)
    return clip_u8, masked_np, recon_np


def save_reconstruction_triptych(model, clip_u8: np.ndarray, mask: torch.Tensor,
                                 patch_size: int, out_path: str, dtype: torch.dtype,
                                 max_frames: int = 4, norm_pix: bool = False) -> str | None:
    """orig | masked | recon rows for the first few frames (pipeline B),
    from :func:`triptych_arrays`, to ``out_path``."""
    if plt is None:
        return None
    rows = triptych_arrays(model, clip_u8, mask, patch_size, dtype, norm_pix=norm_pix)
    n = min(max_frames, clip_u8.shape[0])
    fig, axes = plt.subplots(3, n, figsize=(2.2 * n, 6.8))
    if n == 1:
        axes = axes[:, None]
    for t in range(n):
        for r, (img, title) in enumerate(zip(rows, ("orig", "masked", "recon"))):
            axes[r, t].imshow(img[t])
            axes[r, t].axis("off")
            if t == 0:
                axes[r, t].set_ylabel(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
