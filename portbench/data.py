"""Synthetic training batches: packed `ground_truth` rows shaped like the
data pipeline's output (text spans and audio spans of random codes), and
their collation into tokens and labels. A copy of the program's
`train/data.py::synthetic_dataset` and `collate`, with rows packed to the
full sequence length (no padding), as a packed dataset trains."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IGNORE_INDEX = -100


def packed_rows(n_rows: int, model: dict, semantic_start: int, seq_len: int,
                rng: np.random.Generator) -> List[np.ndarray]:
    """n_rows grids [R, seq_len + 1] of spans: 40% text spans of byte ids,
    60% audio spans (the semantic id of code 0 in row 0, the codes below)."""
    R = model["num_codebooks"] + 1
    out = []
    for _ in range(n_rows):
        T = seq_len + 1
        gt = np.zeros((R, T), dtype=np.int32)
        t = 0
        while t < T:
            span = min(int(rng.integers(4, 24)), T - t)
            if rng.random() < 0.4:
                gt[0, t: t + span] = rng.integers(0, 320, span)
            else:
                codes = rng.integers(0, model["codebook_size"], (model["num_codebooks"], span))
                gt[0, t: t + span] = semantic_start + codes[0]
                gt[1:, t: t + span] = codes
            t += span
        out.append(gt)
    return out


def collate(rows: List[np.ndarray], semantic_pad_id: int, max_len: int) -> Dict[str, np.ndarray]:
    """Grids -> inputs `tokens` [B, R, max_len] and `labels` (the grid
    shifted by one, -100 where padded and on text-only codebook rows)."""
    B, R = len(rows), rows[0].shape[0]
    tokens = np.zeros((B, R, max_len), dtype=np.int32)
    tokens[:, 0, :] = semantic_pad_id
    labels = np.full((B, R, max_len), IGNORE_INDEX, dtype=np.int32)
    for i, gt in enumerate(rows):
        n = min(gt.shape[1] - 1, max_len)
        tokens[i, :, :n] = gt[:, :n]
        label = gt[:, 1: n + 1].copy()
        label[1:, :][label[1:, :] == 0] = IGNORE_INDEX
        labels[i, :, :n] = label
    return {"tokens": tokens, "labels": labels}


def batches(n: int, batch: int, seq_len: int, model: dict, vocab: dict, seed: int):
    """n batches of distinct packed rows, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0xDA7A])
    return [collate(packed_rows(batch, model, vocab["semantic_start"], seq_len, rng),
                    vocab["semantic_pad"], seq_len) for _ in range(n)]
