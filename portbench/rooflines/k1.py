"""K1, the fast loop (all codebook levels of a frame in one call): its
kernels, and the operations and bytes one call at B rows needs.

Bytes: the int8 fast-trunk and head weights with their float32 scales, the
bf16 hidden rows, the bf16 embeddings of the codes fed back, the bf16 norms
and the int32 codes written, each once. Operations: the trunk's and the
depthwise head's products for every level (attention over at most 8
positions is left out)."""

import re

KERNELS = re.compile(r"\b(gemm_i8|fast_attn|fast_sample|init_h)\b")  # csrc/fast_loop.cu


def work(cfg: dict, B: int):
    """(flops, bytes) of one K1 call at B rows; `cfg` the model dict."""
    D = cfg.get("fast_dim") or cfg["dim"]
    H = cfg.get("fast_n_head") or cfg["n_head"]
    KV = cfg.get("fast_n_local_heads") or cfg["n_local_heads"]
    Fi = cfg.get("fast_intermediate_size") or cfg["intermediate_size"]
    L, n, CB = cfg["n_fast_layer"], cfg["num_codebooks"], cfg["codebook_size"]
    Nq = D + 2 * KV * (D // H)
    layer_q = D * Nq + D * D + D * 2 * Fi + Fi * D
    weights = L * layer_q + L * (Nq + D + 2 * Fi + D) * 4 + n * D * CB + n * CB * 4
    nbytes = weights + B * D * 2 + B * (n - 1) * D * 2 + 2 * L * D * 2 + D * 2 + B * n * 4
    flops = n * (L * 2 * B * layer_q + 2 * B * D * CB)
    return flops, nbytes
