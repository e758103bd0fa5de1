"""K2, decode attention over the int8 history and the bf16 ring tail (the
tuned route): its kernel, and the operations and bytes one call needs.

Bytes, each read or written once: the bf16 queries and outputs, every valid
history position (int8 K and V rows and their float32 scales) up to the
attend limit, every valid tail entry (bf16 K and V rows), the int32 tail
positions and the two int32 position vectors. Operations: 4 * H * hd per
attended position (the scores and the weighted sum)."""

import re

KERNELS = re.compile(r"\bdecode_attn_kernel\b")  # csrc/decode_attention.cu, tuned route


def work(cfg: dict, B: int, n_hist: int, n_tail: int, tail_len: int):
    """(flops, bytes) of one call over B slots with `n_hist` history and
    `n_tail` tail positions valid in all (summed over the slots)."""
    H, KV = cfg["n_head"], cfg["n_local_heads"]
    hd = cfg["dim"] // H
    nbytes = (B * H * hd * 2 + n_hist * KV * (2 * hd + 2 * 4) + n_tail * KV * 2 * hd * 2
              + B * tail_len * 4 + 2 * B * 4 + B * H * hd * 2)
    return 4 * H * hd * (n_hist + n_tail), nbytes
