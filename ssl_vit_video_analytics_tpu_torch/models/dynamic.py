"""Dynamic inference: motion scoring, top-k frame gating and confidence-based
early exit (counterpart of the JAX package's ``models/dynamic.py``).

Two early-exit implementations with identical statistics:

- :func:`streaming_early_exit` encodes one frame of the whole batch per step
  and stops as soon as every sample has exited; each frame is encoded at most
  once. The loop condition reads one bool back from the device per step
  (``utils/tracing.host_read``, counted under ``host_syncs``).
- :func:`early_exit_batched` encodes all visited frames in one ``[B*M]``
  batch and rebuilds the running means as prefix sums, added left to right
  in the streaming order and dtype (an explicit loop over M <= 16, not
  ``torch.cumsum``, whose summation order is not specified), so
  ``used_frames``/``final_conf``/logits are bit-identical given bit-identical
  embeddings.

Either counts its calls in the ``early_exit.batches`` counter.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import tracing

# batches served by either implementation, in this process
BATCHES = tracing.counter("early_exit.batches")


class EarlyExitStats(NamedTuple):
    used_frames: torch.Tensor  # [B] int32
    final_conf: torch.Tensor   # [B] float32


def _confidence(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=dim).amax(dim=dim)


def motion_scores_l1(clip: torch.Tensor) -> torch.Tensor:
    """Per-frame L1 frame-difference motion scores, ``[B, T, H, W, C] -> [B, T]``.

    scores[:, 0] = 0; scores[:, t] = mean |frame_t - frame_{t-1}|.
    """
    B, T = clip.shape[:2]
    zeros = torch.zeros((B, 1), dtype=torch.float32, device=clip.device)
    if T <= 1:
        return zeros[:, :T]
    diffs = (clip[:, 1:] - clip[:, :-1]).abs().float().mean(dim=(2, 3, 4))
    return torch.cat([zeros, diffs], dim=1)


def select_topk_frames(clip: torch.Tensor, k: int, score_type: str = "motion",
                       generator: torch.Generator | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep k frames per sample, temporally ordered.

    Returns ``(clip_sel [B, k, H, W, C], idx [B, k] ascending)``. Ties in the
    score go to the earlier frame, as ``lax.top_k`` breaks them. ``random``
    scores are drawn from ``generator`` (a CPU generator).
    """
    B, T = clip.shape[:2]
    k_eff = min(int(k), T)
    if score_type == "motion":
        scores = motion_scores_l1(clip)
    elif score_type == "random":
        if generator is None:
            raise ValueError("random score_type needs a torch.Generator")
        scores = torch.rand((B, T), generator=generator).to(clip.device)
    else:
        raise ValueError(f"Unknown score_type: {score_type}")
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    idx = torch.sort(order[:, :k_eff], dim=1).values
    rows = torch.arange(B, device=clip.device)[:, None]
    return clip[rows, idx], idx


def streaming_early_exit(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    classify_fn: Callable[[torch.Tensor], torch.Tensor],
    clip: torch.Tensor,
    threshold: float,
    min_frames: int = 4,
    max_frames: int | None = None,
    frame_step: int = 1,
) -> tuple[torch.Tensor, EarlyExitStats]:
    """Confidence-based streaming early exit; each frame encoded at most once.

    embed_fn: ``[B, H, W, C] -> [B, D]``; classify_fn: ``[B, D] -> [B, K]``.
    Returns ``(final_logits [B, K], EarlyExitStats)``.
    """
    B, T = clip.shape[:2]
    if max_frames is not None:
        T = min(T, int(max_frames))
        clip = clip[:, :T]
    frame_step = max(int(frame_step), 1)
    min_frames = max(int(min_frames), 1)
    dev = clip.device
    BATCHES.count += 1

    sum_emb = embed_fn(clip[:, 0])
    cnt = torch.ones((B,), dtype=torch.int32, device=dev)
    decided = torch.zeros((B,), dtype=torch.bool, device=dev)
    used = torch.zeros((B,), dtype=torch.int32, device=dev)
    final_logits = None

    def mean_logits(sum_emb, cnt):
        return classify_fn(sum_emb / cnt.clamp(min=1)[:, None].to(sum_emb.dtype))

    def check_and_update(sum_emb, cnt, decided, final_logits, used):
        logits = mean_logits(sum_emb, cnt)
        if final_logits is None:
            final_logits = torch.zeros_like(logits)
        newly = (~decided) & (_confidence(logits, 1) >= threshold) & (cnt >= min_frames)
        final_logits = torch.where(newly[:, None], logits, final_logits)
        used = torch.where(newly, cnt, used)
        return decided | newly, final_logits, used

    decided, final_logits, used = check_and_update(sum_emb, cnt, decided,
                                                   final_logits, used)
    t = 1
    while t < T and not tracing.host_read(decided.all()):
        emb = embed_fn(clip[:, t])
        active = ~decided
        sum_emb = sum_emb + torch.where(active[:, None], emb, torch.zeros_like(emb))
        cnt = cnt + active.to(torch.int32)
        decided, final_logits, used = check_and_update(sum_emb, cnt, decided,
                                                       final_logits, used)
        t += frame_step

    # finalize undecided samples with the full running mean
    remain = ~decided
    final_logits = torch.where(remain[:, None], mean_logits(sum_emb, cnt), final_logits)
    used = torch.where(remain, cnt, used)
    return final_logits, EarlyExitStats(used_frames=used,
                                        final_conf=_confidence(final_logits, 1))


def early_exit_batched(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    classify_fn: Callable[[torch.Tensor], torch.Tensor],
    clip: torch.Tensor,
    threshold: float,
    min_frames: int = 4,
    max_frames: int | None = None,
    frame_step: int = 1,
) -> tuple[torch.Tensor, EarlyExitStats]:
    """Same statistics as :func:`streaming_early_exit`, one batched encode
    of every visited frame instead of a sequential per-frame loop."""
    B, T = clip.shape[:2]
    if max_frames is not None:
        T = min(T, int(max_frames))
        clip = clip[:, :T]
    frame_step = max(int(frame_step), 1)
    min_frames = max(int(min_frames), 1)
    BATCHES.count += 1

    # visited-frame schedule of the streaming loop: 0 first, then 1, 1+s, ...
    visit = [0] + list(range(1, T, frame_step))
    M = len(visit)
    frames = clip[:, visit]                                         # [B, M, ...]
    emb = embed_fn(frames.reshape((B * M,) + frames.shape[2:])).reshape(B, M, -1)

    # prefix sums in streaming order (left-to-right adds -> bit-identical)
    s = torch.zeros_like(emb[:, 0])
    sums = []
    for j in range(M):
        s = s + emb[:, j]
        sums.append(s)
    sums = torch.stack(sums)                                        # [M, B, D]
    cnts = torch.arange(1, M + 1, dtype=torch.int32, device=emb.device)
    means = sums / cnts[:, None, None].to(emb.dtype)
    logits = classify_fn(means.reshape(M * B, -1)).reshape(M, B, -1)
    conf = _confidence(logits, -1)                                  # [M, B]

    eligible = (conf >= threshold) & (cnts[:, None] >= min_frames)  # [M, B]
    first = torch.argmax(eligible.to(torch.int32), dim=0)           # first True
    jstar = torch.where(eligible.any(dim=0), first, torch.full_like(first, M - 1))
    final_logits = logits[jstar, torch.arange(B, device=emb.device)]  # [B, K]
    used = cnts[jstar]
    return final_logits, EarlyExitStats(used_frames=used,
                                        final_conf=_confidence(final_logits, 1))
