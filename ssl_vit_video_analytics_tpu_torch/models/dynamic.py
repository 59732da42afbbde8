"""Dynamic inference: motion scoring, top-k frame gating and confidence-based
early exit (counterpart of the JAX package's ``models/dynamic.py``).

Two early-exit implementations with identical statistics:

- :func:`streaming_early_exit` encodes one frame of the whole batch per step
  and stops as soon as every sample has exited; each frame is encoded at most
  once. The loop condition reads one bool back from the device per step
  (``utils/tracing.host_read``, counted under ``host_syncs``). On a card,
  with grad off and the model in eval mode, each frame's step is one
  replay of a CUDA graph instead of some hundred launches from Python
  (:func:`eager_reason` says when it is not).
- :func:`early_exit_batched` encodes all visited frames in one ``[B*M]``
  batch and rebuilds the running means as prefix sums, added left to right
  in the streaming order and dtype (an explicit loop over M <= 16, not
  ``torch.cumsum``, whose summation order is not specified), so
  ``used_frames``/``final_conf``/logits are bit-identical given bit-identical
  embeddings.

Either counts its calls in the ``early_exit.batches`` counter; the
streaming loop counts its frames in ``early_exit.frames``, those a replay
stepped in ``early_exit.graph_replays``, its captures in
``early_exit.graph_captures`` and their microseconds in
``early_exit.graph_capture_us``. A replay adds the launches of the
kernels it runs to their launch counters, which its capture took back.
"""
from __future__ import annotations

import itertools
import time
import weakref
from typing import Callable, NamedTuple

import torch
from torch import nn

from ..utils import tracing

# batches served by either implementation, in this process
BATCHES = tracing.counter("early_exit.batches")
# the streaming loop's frames, those of them stepped by a CUDA graph's
# replay, its captures, and the microseconds its captures took (the
# graph's warm-up step and the capture)
FRAMES = tracing.counter("early_exit.frames")
REPLAYS = tracing.counter("early_exit.graph_replays")
CAPTURES = tracing.counter("early_exit.graph_captures")
CAPTURE_US = tracing.counter("early_exit.graph_capture_us")


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


class _State(NamedTuple):
    """The streaming loop's state after a frame, one row a sample."""
    sum_emb: torch.Tensor       # [B, D] sum of the embeddings of the frames seen
    cnt: torch.Tensor           # [B] int32, frames summed
    decided: torch.Tensor       # [B] bool, exited
    final_logits: torch.Tensor  # [B, K] the logits at exit, 0 before it
    used: torch.Tensor          # [B] int32, the frames at exit, 0 before it


def _mean_logits(classify_fn, sum_emb, cnt):
    return classify_fn(sum_emb / cnt.clamp(min=1)[:, None].to(sum_emb.dtype))


def _check_and_update(classify_fn, sum_emb, cnt, decided, final_logits, used, threshold,
                      min_frames) -> _State:
    """The samples not yet decided whose running mean's confidence reaches
    ``threshold`` after ``min_frames`` frames or more exit now. ``threshold``
    and ``min_frames`` are numbers, or 0-d fp32 and int32 tensors (the
    graphed step's): a comparison takes the tensor's dtype either way."""
    logits = _mean_logits(classify_fn, sum_emb, cnt)
    if final_logits is None:
        final_logits = torch.zeros_like(logits)
    newly = (~decided) & (_confidence(logits, 1) >= threshold) & (cnt >= min_frames)
    return _State(sum_emb, cnt, decided | newly,
                  torch.where(newly[:, None], logits, final_logits),
                  torch.where(newly, cnt, used))


def _first_frame(embed_fn, classify_fn, frame, threshold, min_frames) -> _State:
    sum_emb = embed_fn(frame)
    B, dev = frame.shape[0], frame.device
    cnt = torch.ones((B,), dtype=torch.int32, device=dev)
    decided = torch.zeros((B,), dtype=torch.bool, device=dev)
    used = torch.zeros((B,), dtype=torch.int32, device=dev)
    return _check_and_update(classify_fn, sum_emb, cnt, decided, None, used, threshold,
                             min_frames)


def _next_frame(embed_fn, classify_fn, frame, s: _State, threshold, min_frames) -> _State:
    emb = embed_fn(frame)
    active = ~s.decided
    sum_emb = s.sum_emb + torch.where(active[:, None], emb, torch.zeros_like(emb))
    cnt = s.cnt + active.to(torch.int32)
    return _check_and_update(classify_fn, sum_emb, cnt, s.decided, s.final_logits, s.used,
                             threshold, min_frames)


def eager_reason(embed_fn, classify_fn, clip: torch.Tensor) -> str | None:
    """Why :func:`streaming_early_exit` runs its frames eagerly on ``clip``,
    or None where it replays them as a CUDA graph.

    A profiler's ranges hold only the kernels that Python launches inside
    them, and a replay launches a frame's kernels from one call: so a
    recording profiler and the port's spans take the eager loop, which runs
    the same kernels in the same order (a traced run's host gaps are then
    the eager loop's, not the graph's). A graph reads the parameters and
    buffers where they were at its capture, so both functions must be
    methods of one module, all of it in eval mode."""
    if torch._C._autograd._profiler_enabled():
        return "a profiler is recording"
    if tracing.enabled():
        return "spans are on"
    if torch.is_grad_enabled():
        return "grad is on"
    module = getattr(embed_fn, "__self__", None)
    if not isinstance(module, nn.Module) or getattr(classify_fn, "__self__", None) is not module:
        return "embed_fn and classify_fn are not methods of one module"
    if any(m.training for m in module.modules()):
        return "the module is in train mode"
    if clip.device.type != "cuda":
        return "the clip is not on a CUDA device"
    if torch.cuda.is_current_stream_capturing():
        return "a CUDA graph is being captured"
    return None


def _capture(step, dev: torch.device) -> tuple:
    """A CUDA graph of ``step``, warmed up once on a side stream first
    (torch.cuda.graph's recipe), and the launches a replay makes, which the
    capture counted and took back off (``tracing.uncounted_launches``).
    "thread_local": a loader's thread may copy batches meanwhile."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                step()

        launched = tracing.uncounted_launches(capture)
    return graph, launched


class _FrameGraph:
    """The loop's step after frame 0, captured once as a CUDA graph over
    static buffers: the frame, ``threshold`` and ``min_frames``, the state
    (:class:`_State`) and whether every sample has exited. Frame 0 replays
    it over a zeroed state, from which it computes what :func:`_first_frame`
    does (a sum of 0 and the embedding, a count of 1, nothing decided).
    Each frame enters by one copy into the frame's buffer."""

    def __init__(self, embed_fn, classify_fn, frame: torch.Tensor, state: _State):
        dev = frame.device
        self.frame = torch.empty(frame.shape, dtype=frame.dtype, device=dev)
        self.threshold = torch.zeros((), dtype=torch.float32, device=dev)
        self.min_frames = torch.ones((), dtype=torch.int32, device=dev)
        self.state = _State(*(torch.zeros_like(t) for t in state))
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.frame.copy_(frame)

        def step():
            new = _next_frame(embed_fn, classify_fn, self.frame, self.state, self.threshold,
                              self.min_frames)
            for dst, src in zip(self.state, new):
                dst.copy_(src)
            self.done.copy_(new.decided.all())

        self.step, self.launched = _capture(step, dev)

    def _replay(self, frame: torch.Tensor) -> None:
        self.frame.copy_(frame)
        self.step.replay()
        tracing.count_launches(self.launched)
        FRAMES.count += 1
        REPLAYS.count += 1

    def run(self, clip: torch.Tensor, T: int, frame_step: int, threshold: float,
            min_frames: int) -> _State:
        """The loop over ``clip``'s frames by replays; the state it leaves
        is in the graph's buffers, which the next call overwrites."""
        self.threshold.fill_(threshold)
        self.min_frames.fill_(min_frames)
        for buf in self.state:
            buf.zero_()
        self._replay(clip[:, 0])
        t = 1
        while t < T and not tracing.host_read(self.done):
            self._replay(clip[:, t])
            t += frame_step
        return self.state


# each module's graphed loops: (the storage of its parameters and buffers
# they were captured over, {key: _FrameGraph}); dropped with the module
_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _storage(module: nn.Module) -> tuple:
    return tuple(t.data_ptr() for t in itertools.chain(module.parameters(), module.buffers()))


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
    Returns ``(final_logits [B, K], EarlyExitStats)``, fresh tensors.

    Where :func:`eager_reason` finds none, the frames replay a CUDA graph
    (:class:`_FrameGraph`), one for each module, frame shape, dtype, device
    and inference mode; the first call for a key runs eagerly and captures
    it after it, and parameters moved to new storage are captured anew. The loop reads ``decided.all()`` once a frame either way.
    """
    T = clip.shape[1]
    if max_frames is not None:
        T = min(T, int(max_frames))
        clip = clip[:, :T]
    frame_step = max(int(frame_step), 1)
    min_frames = max(int(min_frames), 1)
    BATCHES.count += 1

    graphs = key = None
    module = None if eager_reason(embed_fn, classify_fn, clip) else embed_fn.__self__
    if module is not None:
        key = (clip.shape[:1] + clip.shape[2:], clip.dtype, clip.device,
               torch.is_inference_mode_enabled(), embed_fn.__func__, classify_fn.__func__)
        storage = _storage(module)
        if module not in _GRAPHS or _GRAPHS[module][0] != storage:
            _GRAPHS[module] = (storage, {})
        graphs = _GRAPHS[module][1].get(key)

    if graphs is not None:
        s = graphs.run(clip, T, frame_step, threshold, min_frames)
    else:
        s = _first_frame(embed_fn, classify_fn, clip[:, 0], threshold, min_frames)
        FRAMES.count += 1
        t = 1
        while t < T and not tracing.host_read(s.decided.all()):
            s = _next_frame(embed_fn, classify_fn, clip[:, t], s, threshold, min_frames)
            FRAMES.count += 1
            t += frame_step
        if module is not None:
            t0 = time.perf_counter()
            _GRAPHS[module][1][key] = _FrameGraph(embed_fn, classify_fn, clip[:, 0], s)
            CAPTURE_US.count += round((time.perf_counter() - t0) * 1e6)
            CAPTURES.count += 1

    # finalize undecided samples with the full running mean
    remain = ~s.decided
    final_logits = torch.where(remain[:, None], _mean_logits(classify_fn, s.sum_emb, s.cnt),
                               s.final_logits)
    used = torch.where(remain, s.cnt, s.used)
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
