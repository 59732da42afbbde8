"""FedAvg (counterpart of the JAX package's ``federated/core.py``).

The reference simulates federated learning: N client models on one device,
trained one after another, state dicts averaged in-process
(ref: src/run_federated.py:270-325, src/federated/fed_loop.py:65-147). The
JAX package stacks the clients on a ``client`` mesh axis. The port runs a
rank's clients in a loop, as the JAX package's ``mesh=None`` path does:
each client starts from the global ``state_dict`` with a fresh AdamW and
runs its steps in order. Over a ``client`` mesh of n ranks
(``parallel/mesh.py``) the round's clients are padded to a multiple of n
with zero-weight dummies (:func:`pad_clients_to_axis`), rank r runs the
r-th contiguous block of them (the block ``shard_map``'s ``P("client")``
gives device r), and the aggregate is an all-reduce of each rank's
weighted partial sum (the max for integer tensors); the clients' losses
are gathered.

Aggregation dtype rules match the reference exactly
(ref: src/federated/fed_loop.py:46-58): floating tensors get the
client-size-weighted mean; integer tensors (BatchNorm's
``num_batches_tracked``) take the MAX across clients, never an average.

Client sampling keeps the reference's RNG stream, random.Random(42)
.sample(range(N), m) (ref: src/federated/fed_loop.py:86-91), so the selected
client sets are identical run for run.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import all_gather_cat, all_reduce_flat
from ..train.state import AdamW, make_optimizer
from .comm_cost import estimate_comm_mb_per_round

State = Mapping[str, torch.Tensor]


def fedavg_aggregate(client_states: Sequence[State] | State, weights, mesh=None) -> dict:
    """Aggregate client states: a list of ``state_dict``s, or one mapping of
    tensors stacked on axis 0.

    Float tensors -> weighted mean with weights normalized to sum 1;
    integer/bool tensors -> elementwise max across clients. Over a
    ``client`` ``mesh`` the states are this rank's block of the clients
    and ``weights`` are every client's: each rank sums its block, weighted,
    and an all-reduce (max for integers) adds the ranks' partial sums.
    """
    if isinstance(client_states, Mapping):
        stacked = client_states
    else:
        stacked = {k: torch.stack([s[k] for s in client_states]) for k in client_states[0]}
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / w.sum().clamp_min(1e-12)
    if mesh is not None:
        w = w[mesh.block(w.shape[0])]
    out = {}
    for key, x in stacked.items():
        if x.is_floating_point():
            out[key] = (x * w.to(x.device, x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
                        ).sum(dim=0)
        else:
            out[key] = x.amax(dim=0)
    if mesh is not None:
        all_reduce_flat([v for v in out.values() if v.is_floating_point()], mesh.group())
        all_reduce_flat([v for v in out.values() if not v.is_floating_point()], mesh.group(),
                        "max")
    return out


def broadcast_tree(state: State, num_clients: int) -> dict:
    """Replicate a global state to ``[N, ...]`` stacked views."""
    return {k: v.unsqueeze(0).expand((num_clients,) + tuple(v.shape))
            for k, v in state.items()}


def select_clients(rng: random.Random, num_clients: int, fraction: float) -> list[int]:
    """m = max(1, int(N * fraction)) clients per round, reference RNG semantics."""
    m = max(1, int(num_clients * float(fraction)))
    return rng.sample(list(range(num_clients)), m)


def client_loss_and_grads(model, params: Sequence[torch.Tensor], clip: torch.Tensor,
                          labels: torch.Tensor, valid: torch.Tensor):
    """The client step's loss and its gradients for ``params``.

    Train-mode forward of the normalized ``clip`` (every row, padded ones
    too: they enter the BatchNorm batch statistics, as in the JAX step),
    cross-entropy on fp32 logits, ``sum(CE * valid) / max(sum(valid), 1)``
    (``core.py:118-145`` of the JAX package; not the finetune step's mean).
    Returns ``(loss, grads)``."""
    model.train()
    per = F.cross_entropy(model(clip).float(), labels.long(), reduction="none")
    vf = valid.float()
    loss = (per * vf).sum() / vf.sum().clamp_min(1.0)
    return loss.detach(), torch.autograd.grad(loss, list(params))


def client_update(model, tx: AdamW, normalize_fn: Callable, clips: np.ndarray,
                  labels: np.ndarray, valid: np.ndarray, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One client's local steps over host arrays ``clips [S, B, T, H, W, 3]``
    uint8, ``labels [S, B]``, ``valid [S, B]``, in order, on ``model`` and
    ``tx`` in place. The clips go to the card ``chunk`` steps at a time. A
    fully padded step is skipped: no forward (train-mode BatchNorm would move
    its statistics), no optimizer count, as the JAX step's ``where``.
    Returns the step losses times their valid rows, summed, and the valid
    rows (fp32 scalars on the model's device)."""
    device = next(model.parameters()).device
    loss_sum = torch.zeros((), device=device)
    count = torch.zeros((), device=device)
    for k in range(0, clips.shape[0], chunk):
        live = [s for s in range(k, min(k + chunk, clips.shape[0])) if valid[s].any()]
        if not live:
            continue
        clip_c = torch.from_numpy(np.ascontiguousarray(clips[k:k + chunk])).to(device)
        label_c = torch.from_numpy(np.ascontiguousarray(labels[k:k + chunk])).to(device)
        valid_c = torch.from_numpy(np.ascontiguousarray(valid[k:k + chunk])).to(device)
        for s in live:
            loss, grads = client_loss_and_grads(model, tx.params, normalize_fn(clip_c[s - k]),
                                                label_c[s - k], valid_c[s - k])
            tx.update(grads)
            n = valid_c[s - k].float().sum()
            loss_sum += loss * n
            count += n
    return loss_sum, count


def make_parallel_client_update(
    model,
    lr: float,
    weight_decay: float,
    normalize_fn: Callable,
    step_chunk: int | None = None,
    chunk_budget_bytes: int = 512 << 20,
):
    """Build the local update of every client of a round, on ``model``'s
    device.

    Each client gets a FRESH AdamW per round (optax ``adamw``: decay on every
    param, no clipping; ref: src/federated/client_sim.py:36): the optimizer
    state is made at the client's start and dropped at its end; nothing
    crosses rounds.

    ``parallel_update(global_state, clips, labels, valid)`` takes host arrays
    stacked on axis 0 = clients:
      clips:  [N, S, B, T, H, W, 3] uint8
      labels: [N, S, B] int
      valid:  [N, S, B] bool   (padding mask; clients have ragged step counts)
    and returns ``(client_states, avg_loss [N])``: each client's
    ``state_dict`` after its steps (params, BatchNorm statistics) and its
    sample-weighted loss ``loss_sum / max(count, 1)``.

    The step axis S goes to the card in CHUNKS of at most ``step_chunk``
    steps (default: as many as keep one client's chunk of uint8 clips under
    ``chunk_budget_bytes``; the JAX package sizes its chunk over all the
    clients it runs at once). The optimizer state, BatchNorm statistics and
    loss sums carry across chunks, so the result does not depend on the
    chunking.
    """

    def parallel_update(global_state: State, clips, labels, valid):
        clips, labels, valid = np.asarray(clips), np.asarray(labels), np.asarray(valid)
        n, s = clips.shape[:2]
        per_step = int(np.prod(clips.shape[2:]))  # one client's uint8 bytes a step
        chunk = step_chunk or max(1, min(s, int(chunk_budget_bytes) // max(1, per_step)))
        states, loss_sums, counts = [], [], []
        for i in range(n):
            model.load_state_dict(global_state)
            tx = make_optimizer(model.parameters(), float(lr), weight_decay=float(weight_decay))
            loss_sum, count = client_update(model, tx, normalize_fn, clips[i], labels[i],
                                            valid[i], chunk)
            states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
            loss_sums.append(loss_sum)
            counts.append(count)
        return states, torch.stack(loss_sums) / torch.stack(counts).clamp_min(1.0)

    return parallel_update


def pad_clients_to_axis(client_batches: dict, client_sizes: np.ndarray,
                        axis_size: int) -> tuple[dict, np.ndarray, int]:
    """Pad the stacked client dim to a multiple of the ``client`` mesh's
    size (one card needs no padding).

    Dummy clients get all-False ``valid`` masks (their local updates are
    no-ops) and zero aggregation weight. Returns (padded_batches,
    padded_sizes, n_real).
    """
    n = int(client_sizes.shape[0])
    n_pad = (-n) % int(axis_size)
    if n_pad == 0:
        return client_batches, client_sizes, n
    padded = {k: np.concatenate(
        [np.asarray(v), np.zeros((n_pad,) + v.shape[1:], dtype=np.asarray(v).dtype)])
        for k, v in client_batches.items()}
    sizes = np.concatenate([np.asarray(client_sizes, np.float32),
                            np.zeros((n_pad,), np.float32)])
    return padded, sizes, n


def run_fedavg_round(parallel_update, global_state: State, client_batches: dict,
                     client_sizes: np.ndarray, mesh=None) -> tuple[dict, torch.Tensor]:
    """One round: local updates from the global state -> weighted aggregate.

    client_batches: {"clip": [N,S,B,...] uint8, "label": [N,S,B], "valid": [N,S,B]}
    (every client's, on every rank). Over a ``client`` ``mesh`` the clients
    are padded to the mesh, this rank runs its block, and the aggregate and
    the losses are the whole round's on every rank.
    Returns (new_global_state, local_losses [N]).
    """
    if mesh is None:
        states, losses = parallel_update(global_state, client_batches["clip"],
                                         client_batches["label"], client_batches["valid"])
        return fedavg_aggregate(states, client_sizes), losses
    client_batches, client_sizes, n_real = pad_clients_to_axis(client_batches, client_sizes,
                                                               mesh.size())
    mine = mesh.block(len(client_sizes))
    states, losses = parallel_update(global_state, *(np.asarray(client_batches[k])[mine]
                                                     for k in ("clip", "label", "valid")))
    return (fedavg_aggregate(states, client_sizes, mesh),
            all_gather_cat(losses, mesh.group())[:n_real])


def run_fedavg(
    parallel_update,
    global_state: State,
    sample_round_batches: Callable[[list[int], int], tuple[dict, np.ndarray]],
    evaluate_fn: Callable,
    num_clients: int,
    rounds: int = 10,
    client_fraction: float = 1.0,
    log=print,
    mesh=None,
) -> tuple[list[dict], dict]:
    """Full FedAvg loop (ref: src/federated/fed_loop.py:65-147).

    sample_round_batches(selected, round) -> (client_batches, client_sizes).
    evaluate_fn(state) -> (top1, top5).
    Returns (records, final_state). Besides the JAX package's lines, each
    round logs its client steps (fully padded ones left out) and the seconds
    of its local updates, and the round's seconds. ``mesh``: the ``client``
    mesh the rounds run over (:func:`run_fedavg_round`).
    """
    rng = random.Random(42)
    records = []
    for r in range(1, int(rounds) + 1):
        t0 = time.perf_counter()
        selected = select_clients(rng, num_clients, client_fraction)
        log(f"[INFO] Round {r}/{rounds} selected_clients={selected}")

        batches, sizes = sample_round_batches(selected, r)
        steps = int(np.asarray(batches["valid"]).any(axis=2).sum())
        global_state, losses = run_fedavg_round(parallel_update, global_state, batches, sizes,
                                                mesh)
        local_losses = losses.tolist()  # waits for the last client step
        log(f"[INFO] Round {r} local updates: {steps} client steps in "
            f"{time.perf_counter() - t0:.3f}s")

        # full transmitted state = params + BN running statistics, matching
        # the reference's state_dict accounting (ref:
        # src/federated/comm_cost.py:4-10 measures the whole state_dict)
        comm_total_mb, model_mb = estimate_comm_mb_per_round(
            global_state, num_clients_participating=len(selected))
        top1, top5 = evaluate_fn(global_state)
        rec = {
            "round": r,
            "val_top1": float(top1),
            "val_top5": float(top5),
            "avg_local_loss": float(sum(local_losses) / max(1, len(local_losses))),
            "clients": int(len(selected)),
            "model_mb": float(model_mb),
            "comm_mb_round": float(comm_total_mb),
        }
        records.append(rec)
        log(f"[INFO] Round {r} val_top1={rec['val_top1']:.4f} val_top5={rec['val_top5']:.4f} "
            f"avg_local_loss={rec['avg_local_loss']:.4f} comm_mb={rec['comm_mb_round']:.2f} "
            f"seconds={time.perf_counter() - t0:.3f}")
    return records, global_state
