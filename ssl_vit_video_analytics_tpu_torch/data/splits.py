"""Split files and federated non-IID class-shard splitting.

Split file format is the reference's: one ``<frame_dir> <label>`` pair per
line (ref: src/datasets/loader.py:45-51). The class-shard splitter reproduces
the reference's algorithm semantics exactly — same RNG stream
(random.Random(seed)), same class-shuffle → wrap-around assignment → greedy
largest-to-smallest rebalance — so client shards are bit-identical given the
same base split (ref: src/datasets/federated_split.py:26-105).
"""
from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import Sequence

from ..utils.io import ensure_dir


def read_split(split_file: str) -> list[tuple[str, int]]:
    items: list[tuple[str, int]] = []
    with open(split_file, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            path, label = line.split()
            items.append((path, int(label)))
    if not items:
        raise RuntimeError(f"[ERROR] Empty split file: {split_file}")
    return items


def write_split(items: Sequence[tuple[str, int]], out_path: str) -> None:
    ensure_dir(os.path.dirname(out_path) or ".")
    with open(out_path, "w", encoding="utf-8") as f:
        for p, y in items:
            f.write(f"{p} {y}\n")


def make_class_shard_splits(
    base_split_file: str,
    num_clients: int,
    shards_per_client: int = 6,
    seed: int = 42,
    min_samples_per_client: int = 200,
    out_prefix: str = "fed",
    out_dir: str = "data/splits",
    write: bool = True,
) -> tuple[list[str], list[dict]]:
    """Non-IID class-shard client splits.

    Each class becomes one shard; clients get ``shards_per_client`` consecutive
    shards of a seeded class shuffle (wrap-around), then a bounded greedy
    rebalance moves samples from the largest client to the smallest until every
    client has ``min_samples_per_client``. Writes
    ``{out_dir}/{out_prefix}_client_{i}_train.txt`` (unless ``write`` is
    False: the other ranks of a launch, which rank 0 writes for) and returns
    (paths, stats).
    """
    rng = random.Random(seed)

    items = read_split(base_split_file)
    by_class: dict[int, list[tuple[str, int]]] = defaultdict(list)
    for p, y in items:
        by_class[y].append((p, y))

    for y in by_class:
        rng.shuffle(by_class[y])

    class_ids = sorted(by_class.keys())
    rng.shuffle(class_ids)

    client_items: list[list[tuple[str, int]]] = [[] for _ in range(num_clients)]
    for pos, cid in enumerate(class_ids):
        client_id = (pos // shards_per_client) % num_clients
        client_items[client_id].extend(by_class[cid])

    # Greedy rebalance, bounded iterations, 200 samples max per move.
    for _ in range(200):
        sizes = [len(ci) for ci in client_items]
        mn, mx = min(sizes), max(sizes)
        if mn >= min_samples_per_client:
            break
        small, large = sizes.index(mn), sizes.index(mx)
        if len(client_items[large]) <= min_samples_per_client:
            break
        move_n = min(200, len(client_items[large]) - min_samples_per_client)
        client_items[small].extend(client_items[large][:move_n])
        client_items[large] = client_items[large][move_n:]

    out_paths, out_stats = [], []
    for i in range(num_clients):
        out_path = os.path.join(out_dir, f"{out_prefix}_client_{i}_train.txt")
        if write:
            write_split(client_items[i], out_path)
        out_paths.append(out_path)
        cls_set = sorted({y for _, y in client_items[i]})
        out_stats.append({
            "client": i,
            "num_samples": len(client_items[i]),
            "num_classes": len(cls_set),
            "classes": " ".join(map(str, cls_set[:50])),
        })
    return out_paths, out_stats


def train_val_test_split(
    samples_by_class: dict[int, list[str]],
    ratios: tuple[float, float, float] = (0.7, 0.15, 0.15),
    seed: int = 42,
) -> dict[str, list[tuple[str, int]]]:
    """Per-class shuffled train/val/test split (ref: preprocess/generate_splits_lazy.py:43-72)."""
    rng = random.Random(seed)
    out = {"train": [], "val": [], "test": []}
    for label in sorted(samples_by_class):
        paths = list(samples_by_class[label])
        rng.shuffle(paths)
        n = len(paths)
        n_train = int(n * ratios[0])
        n_val = int(n * ratios[1])
        out["train"] += [(p, label) for p in paths[:n_train]]
        out["val"] += [(p, label) for p in paths[n_train:n_train + n_val]]
        out["test"] += [(p, label) for p in paths[n_train + n_val:]]
    return out
