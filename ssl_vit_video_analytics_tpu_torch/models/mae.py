"""MAE models (counterpart of the JAX package's ``models/mae.py``):
pixel-space TinyVideoMAE (pipeline B) and feature-space TinyViTMAE
(pipeline C).

Pipeline B (ref: src/models/mae_vit_adapter.py:5-116):

Frames folded into the batch -> TinyViT stage-3 features ``[BT, 14, 14,
384]`` -> linear to the decoder width -> factorized temporal ``[1, T, 1, D]``
+ spatial ``[1, 1, 196, D]`` position embeddings -> mask-token substitution
(masking happens AFTER encoding; the encoder sees every frame) ->
full-sequence transformer decoder over T*196 = 3136 tokens -> per-patch
pixel head (8*8*3 = 192). Returns the full ``[B, N, 192]`` prediction; the
loss masks with weights. With ``decoder_moe_experts`` > 0 the decoder's MLPs
are top-1-routed experts (``layers.MoeMlp``, ``configs/ssl_mae_moe.yaml``),
whose load-balance auxiliaries ``forward(..., with_aux=True)`` returns.
Under pipeline parallelism the step runs :meth:`TinyVideoMAE.embed_tokens`,
a stage's decoder blocks and :meth:`TinyVideoMAE.predict_pixels` apart
(``train/mae_engine.pipeline_loss_and_grads``, ``parallel/pp.py``).

Pipeline C (ref: src/models/tinyvit_mae.py:35-115): per-frame full TinyViT
(four stages) -> stage-4 feature map adaptively pooled to ``stage4_pool**2``
tokens -> mask-token substitution -> decoder -> prediction back to the
encoder width. Returns ``(rec, target)`` over all ``[B, N, D]`` tokens; the
target is the encoder's tokens, detached, while the encoder still gets a
gradient through the unmasked tokens of the decoder's input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import TransformerEncoder, adaptive_avg_pool_nhwc, linear
from .tiny_vit import TinyViT


class TinyVideoMAE(nn.Module):
    """Pixel-reconstruction VideoMAE over TinyViT stage-3 features."""

    def __init__(self, encoder: TinyViT, clip_len: int = 16, img_size: int = 112,
                 patch_size: int = 8, decoder_embed_dim: int = 384, decoder_depth: int = 4,
                 decoder_num_heads: int = 6, dtype: torch.dtype = torch.float32,
                 attn_impl: str | None = None, decoder_moe_experts: int = 0,
                 decoder_moe_capacity_factor: float = 2.0, decoder_moe_group_size: int = 0):
        super().__init__()
        if len(encoder.stages) < 3:
            raise ValueError("TinyVideoMAE taps TinyViT stage 3: build it with num_stages >= 3")
        D = decoder_embed_dim
        self.num_patches = (img_size // patch_size) ** 2
        self.decoder_embed_dim = D
        self.decoder_moe_experts = decoder_moe_experts
        self.dtype = dtype
        self.encoder = encoder
        self.enc_to_dec = nn.Linear(encoder.embed_dims[2], D)
        self.temporal_pos_embed = nn.Parameter(torch.zeros(1, clip_len, 1, D))
        self.spatial_pos_embed = nn.Parameter(torch.zeros(1, 1, self.num_patches, D))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, D))
        for p in (self.temporal_pos_embed, self.spatial_pos_embed, self.mask_token):
            nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04)  # flax truncated_normal(0.02)
        self.decoder = TransformerEncoder(D, decoder_depth, decoder_num_heads, mlp_ratio=4.0,
                                          dtype=dtype, attn_impl=attn_impl,
                                          moe_experts=decoder_moe_experts,
                                          moe_capacity_factor=decoder_moe_capacity_factor,
                                          moe_group_size=decoder_moe_group_size)
        self.decoder_norm = nn.LayerNorm(D, eps=1e-5)
        self.decoder_pred = nn.Linear(D, patch_size ** 2 * 3)

    def draw_drop_path(self, batch: int, frames: int, generator: torch.Generator,
                       device=None) -> list:
        """The encoder's stochastic-depth decisions for ``batch`` clips of
        ``frames`` frames (the decoder has none)."""
        return self.encoder.draw_drop_path(batch * frames, generator, device, stage_limit=3)

    def embed_tokens(self, clip: torch.Tensor, mask: torch.Tensor,
                     drop: list | None = None, frame_offset: int = 0) -> torch.Tensor:
        """Encode -> project to the decoder width -> position embeddings ->
        mask-token substitution. Returns ``[B, T*L, D]``. ``clip`` holds
        frames ``frame_offset ..`` of the clip (a ``seq`` mesh's block),
        which take their slice of the temporal embedding."""
        B, T, H, W, C = clip.shape
        L, D = self.num_patches, self.decoder_embed_dim
        latent = self.encoder.forward_stage3(clip.reshape(B * T, H, W, C), drop)
        latent = latent.reshape(B * T, latent.shape[1] * latent.shape[2], latent.shape[3])
        x = linear(latent, self.enc_to_dec, self.dtype).reshape(B, T, L, D)
        t_pos = self.temporal_pos_embed[:, frame_offset:frame_offset + T]
        x = x + (t_pos + self.spatial_pos_embed).to(x.dtype)
        m = mask.reshape(B, T, L, 1).to(x.dtype)
        x = x * (1.0 - m) + self.mask_token.to(x.dtype)[:, None] * m
        return x.reshape(B, T * L, D)

    def predict_pixels(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm + pixel head."""
        ln = self.decoder_norm
        x = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
        return linear(x.to(self.dtype), self.decoder_pred, self.dtype)

    def forward(self, clip: torch.Tensor, mask: torch.Tensor,
                drop: list | None = None, with_aux: bool = False, frame_offset: int = 0):
        """clip ``[B, T, H, W, 3]`` float; mask ``[B, T, L]`` bool (True =
        masked); drop: the encoder's decisions (:meth:`draw_drop_path`).
        Returns pred ``[B, T*L, patch_size**2 * 3]``, or with ``with_aux``
        ``(pred, auxes)``: the MoE decoder blocks' load-balance auxiliaries
        (empty for the dense decoder). Under a ``seq`` mesh ``clip`` is
        this rank's block of frames from ``frame_offset`` on, and the
        decoder (built with ``attn_impl="sp"``) attends over every rank's
        tokens."""
        x, auxes = self.decoder(self.embed_tokens(clip, mask, drop, frame_offset),
                                with_aux=True)
        pred = self.predict_pixels(x)
        return (pred, auxes) if with_aux else pred


class MAEDecoder(nn.Module):
    """proj -> transformer blocks -> predict back to the embedding width
    (ref: src/models/tinyvit_mae.py:12-32)."""

    def __init__(self, embed_dim: int, decoder_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 attn_impl: str | None = None):
        super().__init__()
        self.proj = nn.Linear(embed_dim, decoder_dim)
        self.blocks = TransformerEncoder(decoder_dim, depth, num_heads, mlp_ratio=mlp_ratio,
                                         dtype=dtype, attn_impl=attn_impl)
        self.pred = nn.Linear(decoder_dim, embed_dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.blocks(linear(x, self.proj, self.dtype))
        return linear(x, self.pred, self.dtype)


class TinyViTMAE(nn.Module):
    """Feature-space token MAE: targets are the detached encoder tokens."""

    def __init__(self, encoder: TinyViT, stage4_pool: int = 3, decoder_dim: int = 512,
                 decoder_depth: int = 2, decoder_num_heads: int = 8, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, attn_impl: str | None = None):
        super().__init__()
        embed_dim = encoder.embed_dims[len(encoder.stages) - 1]
        self.encoder = encoder
        self.stage4_pool = stage4_pool
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        nn.init.trunc_normal_(self.mask_token, 0.0, 0.02, -0.04, 0.04)
        # attn_impl reaches the decoder only ("sp": a seq mesh's block of
        # frames attends over every rank's tokens; the encoder is per frame)
        self.decoder = MAEDecoder(embed_dim, decoder_dim, decoder_depth, decoder_num_heads,
                                  mlp_ratio=mlp_ratio, dtype=dtype, attn_impl=attn_impl)

    def draw_drop_path(self, batch: int, frames: int, generator: torch.Generator,
                       device=None) -> list:
        """The encoder's stochastic-depth decisions for ``batch`` clips of
        ``frames`` frames (the decoder has none)."""
        return self.encoder.draw_drop_path(batch * frames, generator, device)

    def forward(self, clip: torch.Tensor, token_mask: torch.Tensor,
                drop: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """clip ``[B, T, H, W, 3]``; token_mask ``[B, T*P]`` bool, P =
        stage4_pool**2; drop: the encoder's decisions (:meth:`draw_drop_path`).
        Returns ``(rec [B, N, D], target [B, N, D])``."""
        B, T, H, W, C = clip.shape
        feat = self.encoder(clip.reshape(B * T, H, W, C), drop=drop)      # [BT, h, w, D]
        pooled = adaptive_avg_pool_nhwc(feat, self.stage4_pool)           # [BT, s, s, D]
        tok = pooled.reshape(B, T * self.stage4_pool ** 2, pooled.shape[-1])
        tok_in = torch.where(token_mask[..., None], self.mask_token.to(tok.dtype), tok)
        return self.decoder(tok_in), tok.detach()
