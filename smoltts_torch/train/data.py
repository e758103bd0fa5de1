"""Training data: split resolution, collation, batching, synthetic rows.
numpy only; the arrays equal the JAX package's bit for bit.

Rows are `ground_truth` [R, T] grids; inputs are `[:, :-1]`, labels
`[:, 1:]`; token row 0 pads with the semantic pad id, codebook rows pad with
0; labels are -100 where padded and where codebook rows are 0 (text-only
positions). Batches pad to a fixed `max_len`; `process_index` /
`process_count` slice an epoch for data parallelism.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

IGNORE_INDEX = -100


def load_splits(path: str, test_size: int = 10_000, seed: Optional[int] = None):
    """(train, test) splits of an HF `datasets` directory (`datasets` is
    imported here, as only this function needs it). test_size is clamped so
    small datasets still split. The random splits draw fresh entropy, or
    from `seed` (which the processes of one run share)."""
    from datasets import Dataset, load_from_disk

    dataset = load_from_disk(path)

    def clamp(ds):
        return min(test_size, max(1, len(ds) // 10))

    if isinstance(dataset, Dataset):
        dataset = dataset.train_test_split(test_size=clamp(dataset), seed=seed)
    splits = list(dataset.keys())
    if "full" in splits:
        ds = dataset["full"]
        split = ds.shuffle(seed=seed).train_test_split(test_size=clamp(ds), seed=seed)
        return split["train"], split["test"]
    if "val" in splits:
        return dataset["train"].shuffle(42), dataset["val"]
    if "test" in splits:
        return dataset["train"].shuffle(42), dataset["test"]
    split = dataset["train"].train_test_split(test_size=clamp(dataset["train"]), seed=seed)
    return split["train"], split["test"]


def collate(
    rows: List[np.ndarray],
    semantic_pad_id: int,
    max_len: int,
    duplicate_code_0: bool = True,
    num_codebooks: int = 8,
) -> Dict[str, np.ndarray]:
    """Collate `ground_truth` grids -> fixed-shape tokens/labels/pad_mask."""
    height = num_codebooks + (1 if duplicate_code_0 else 0)
    B = len(rows)
    tokens = np.zeros((B, height, max_len), dtype=np.int32)
    tokens[:, 0, :] = semantic_pad_id
    labels = np.full((B, height, max_len), IGNORE_INDEX, dtype=np.int32)
    pad_mask = np.ones((B, max_len), dtype=bool)

    for i, gt in enumerate(rows):
        gt = np.asarray(gt)
        seq_len = min(gt.shape[1] - 1, max_len)
        tokens[i, :, :seq_len] = gt[:, :seq_len]
        label = gt[:, 1 : seq_len + 1].copy()
        text_only = label[1:, :] == 0
        label[1:, :][text_only] = IGNORE_INDEX
        labels[i, :, :seq_len] = label
        pad_mask[i, :seq_len] = False
    return {"tokens": tokens, "labels": labels, "pad_mask": pad_mask}


def batch_iterator(
    dataset,
    batch_size: int,
    semantic_pad_id: int,
    max_len: int,
    duplicate_code_0: bool = True,
    num_codebooks: int = 8,
    accumulate_steps: int = 1,
    seed: int = 0,
    epochs: int = 1,
    process_index: int = 0,
    process_count: int = 1,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epoch iterator over a dataset of `ground_truth` rows.

    Each process reads its own 1/process_count slice of an epoch. When
    accumulate_steps > 1 the batch gains a leading microbatch axis.
    """
    n = len(dataset)
    eff_batch = batch_size * accumulate_steps
    stride = eff_batch * process_count
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = rng.permutation(n)
        for start in range(process_index * eff_batch, n - (stride - 1), stride):
            idx = order[start : start + eff_batch]
            rows = [np.asarray(dataset[int(i)]["ground_truth"]) for i in idx]
            batch = collate(
                rows, semantic_pad_id, max_len, duplicate_code_0, num_codebooks
            )
            if accumulate_steps > 1:
                batch = {
                    k: v.reshape(accumulate_steps, batch_size, *v.shape[1:])
                    for k, v in batch.items()
                }
            yield batch


def synthetic_dataset(
    num_rows: int,
    cfg,
    token_cfg,
    seq_len: int = 256,
    seed: int = 0,
) -> List[Dict[str, np.ndarray]]:
    """Synthetic `ground_truth` rows shaped like the real pipeline output:
    text spans and audio spans of random codes, for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    R = cfg.num_rows
    out = []
    for _ in range(num_rows):
        T = int(rng.integers(seq_len // 2, seq_len + 1))
        gt = np.zeros((R, T), dtype=np.int32)
        t = 0
        while t < T:
            span = int(rng.integers(4, 24))
            span = min(span, T - t)
            if rng.random() < 0.4:  # text span
                gt[0, t : t + span] = rng.integers(0, 320, span)
            else:  # audio span
                codes = rng.integers(0, cfg.codebook_size, (cfg.num_codebooks, span))
                gt[0, t : t + span] = token_cfg.semantic_start_id + codes[0]
                if cfg.duplicate_code_0:
                    gt[1:, t : t + span] = codes
                else:
                    gt[1:, t : t + span] = codes[1:]
            t += span
        out.append({"ground_truth": gt})
    return out
