"""Model FLOPs from shapes: a train step, an LM frame of one stream and a
vocoder frame, each counted as the model's products (2 per multiply-add),
with no recompute and no padding."""

from __future__ import annotations

from portbench.reference.mimi import decoder_plan
from portbench.rooflines import k1


def _trunk_params(n_layer, dim, q, kv, ffn):
    return n_layer * (dim * (q + 2 * kv) + q * dim + 3 * dim * ffn)


def _dims(cfg: dict):
    fd = cfg.get("fast_dim") or cfg["dim"]
    fh = cfg.get("fast_n_head") or cfg["n_head"]
    fkv = cfg.get("fast_n_local_heads") or cfg["n_local_heads"]
    ff = cfg.get("fast_intermediate_size") or cfg["intermediate_size"]
    hd, fhd = cfg["dim"] // cfg["n_head"], fd // fh
    n_slow = _trunk_params(cfg["n_layer"], cfg["dim"], cfg["n_head"] * hd,
                           cfg["n_local_heads"] * hd, cfg["intermediate_size"])
    n_fast = _trunk_params(cfg["n_fast_layer"], fd, fh * fhd, fkv * fhd, ff)
    return fd, n_slow, n_fast


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward + 2x backward): the fast trunk
    runs num_codebooks tokens per slow token, the depthwise head one
    [fast_dim, cb] product per level; causal attention halved; remat
    recompute excluded (bench_train.py's count)."""
    fd, n_slow, n_fast = _dims(cfg)
    BT = batch * seq
    n = cfg["num_codebooks"]
    fwd = 2.0 * n_slow * BT + 2.0 * n_fast * BT * n + 2.0 * cfg["dim"] * cfg["vocab_size"] * BT
    fwd += 2.0 * n * fd * cfg["codebook_size"] * BT
    if fd != cfg["dim"]:
        fwd += 2.0 * cfg["dim"] * fd * BT
    fwd += cfg["n_layer"] * 2.0 * batch * seq * seq * cfg["dim"]
    fwd += cfg["n_fast_layer"] * 2.0 * BT * n * n * fd
    return 3.0 * fwd


def lm_frame_flops(cfg: dict, context: int) -> float:
    """One stream's LM frame at `context` cached positions: the slow trunk's
    products for one token, its attention over the context, the tied head,
    and K1's products for one row."""
    _, n_slow, _ = _dims(cfg)
    attn = cfg["n_layer"] * 4.0 * cfg["dim"] * context
    head = 2.0 * cfg["dim"] * cfg["vocab_size"]
    return 2.0 * n_slow + attn + head + k1.work(cfg, 1)[0]


def vocoder_frame_flops(codec: dict) -> float:
    """One stream's vocoder frame (80 ms): the RVQ output projections, the
    upsample, the decoder transformer on its 2 tokens (attention over a full
    window) and the SEANet decoder's convolutions over the frame's samples."""
    d, ff, L = codec["hidden_size"], codec["intermediate_size"], codec["num_hidden_layers"]
    flops = 2 * 2.0 * codec["codebook_dim"] * d  # semantic + acoustic out_proj
    steps = 2  # decoder transformer tokens per frame (25 Hz)
    flops += steps * d * 4 * 2.0  # depthwise upsample, kernel 4
    flops += steps * L * (4 * 2.0 * d * d + 2 * 2.0 * d * ff + 4.0 * d * codec["sliding_window"])
    length = steps
    for spec in decoder_plan(codec):
        if spec["kind"] == "conv":
            flops += 2.0 * spec["cin"] * spec["cout"] * spec["k"] * length
        elif spec["kind"] == "convtr":
            flops += 2.0 * spec["cin"] * spec["cout"] * spec["k"] * length
            length *= spec["stride"]
        elif spec["kind"] == "resnet":
            flops += 2.0 * spec["ch"] * spec["hidden"] * (spec["k"] + 1) * length
    return flops
