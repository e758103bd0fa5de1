"""DualAR / RQ-Transformer: dimensions, random init, the embedding merge,
the tied token head, the fast input projection, and the teacher-forced
training forward (`forward_train`: slow trunk, then the fast trunk dense over
every frame, frame-folded as the JAX package folds it).

Parameters are a nested dict with the JAX package's key names; per-trunk
layer weights are stacked along a leading layer axis. `DualARDecoder` holds
such a tree as registered buffers.

On a mesh (parallel/mesh.py) the training forward runs this rank's rows of
the batch on its part of the tree (`shard_params`), whichever leaves that
splits: a trunk whose wqkv is narrower than the whole runs tensor-parallel,
a table with fewer rows is looked up vocab-parallel, a narrower head's
logits are gathered. With `activation_sharding` the slow trunk also splits
the sequence over the model axis.
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional

import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig
from smoltts_torch.interop import TensorTree, tree_map
from smoltts_torch.models.layers import (
    AttnDims,
    FoldWindow,
    KeepWindow,
    WHOLE,
    Shard,
    fold_in,
    remat_call,
    rms_norm,
    rope_cos_sin,
    split_seed,
    transformer_block,
)
from smoltts_torch.ops.quant import QTensor, mm, qindex
from smoltts_torch.parallel.collectives import (
    copy_model,
    gather_model,
    reduce_model,
    scatter_model,
)
from smoltts_torch.parallel.mesh import SEQUENCE_SHARDING, head_range

DualARParams = Dict[str, Any]


class TrainForwardResult(NamedTuple):
    token_logits: torch.Tensor  # [B, T, vocab]
    codebook_logits: torch.Tensor  # [B, T, max_fast_seqlen, codebook_size]
    hidden_states: torch.Tensor  # [B, T, dim] pre-norm slow output


def slow_dims(cfg: DualARConfig, mesh=None) -> AttnDims:
    """The slow trunk's attention dims; on a tensor-parallel `mesh`
    (parallel/mesh.py) this rank's query heads and the kv heads they read."""
    if mesh is None or mesh.n_model == 1:
        return AttnDims(cfg.n_head, cfg.n_local_heads, cfg.head_dim, cfg.dim)
    q0, q1, kv0, kv1 = head_range(cfg.n_head, cfg.n_local_heads, mesh.n_model, mesh.model)
    return AttnDims(q1 - q0, kv1 - kv0, cfg.head_dim, cfg.dim)


def fast_dims(cfg: DualARConfig) -> AttnDims:
    return AttnDims(cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim, cfg.fast_dim)


def trunk_shard(dims: AttnDims, layer_params: dict, mesh, frames: int, first: int,
                seq: bool = False, window=KeepWindow):
    """(this rank's dims, its Shard) for a trunk of whole dims `dims` on
    `mesh`: split when its wqkv is narrower than the whole (shard_params on
    a model axis), the rank's heads then its head_range. The dropout window
    covers rows [first, first + local) of `frames` global batch rows (or
    frames, for the fast trunk's FoldWindow, built by the caller)."""
    w = layer_params["wqkv"]
    width = (w.q if isinstance(w, QTensor) else w).shape[-1]
    split = mesh.n_model > 1 and width != dims.q_size + 2 * dims.kv_size
    q0 = 0
    if split:
        q0, q1, kv0, kv1 = head_range(dims.n_head, dims.n_kv_head, mesh.n_model, mesh.model)
        local = AttnDims(q1 - q0, kv1 - kv0, dims.head_dim, dims.dim)
    else:
        local = dims
    win = window(b0=first, B=frames, q0=q0, H=dims.n_head, KV=dims.n_kv_head)
    return local, Shard(mesh=mesh, split=split, seq=seq, window=win)


def _lookup(table: torch.Tensor, ids: torch.Tensor, rows: int, mesh, sum_dim=None):
    """table[ids] (summed over `sum_dim`); a table split by rows over the
    mesh's model axis (fewer than `rows`) is looked up vocab-parallel: each
    rank takes the ids in its row range, zeros the others, and the model
    axis sums the result."""
    local_rows = table.shape[0]
    if mesh is None or local_rows == rows:
        emb = table[ids]
        return emb if sum_dim is None else emb.sum(dim=sum_dim)
    local = ids - mesh.model * local_rows
    hit = (local >= 0) & (local < local_rows)
    emb = table[local.clamp(0, local_rows - 1)]
    emb = torch.where(hit[..., None], emb, torch.zeros_like(emb))
    return reduce_model(emb if sum_dim is None else emb.sum(dim=sum_dim), mesh)


def semantic_offsets(cfg: DualARConfig, device=None) -> torch.Tensor:
    """Per-level offsets into the shared codebook embedding table [num_rows-1]."""
    offs = torch.arange(cfg.num_codebooks, dtype=torch.int64, device=device) * cfg.codebook_size
    return offs if cfg.duplicate_code_0 else offs[1:]


def fast_codebook_offsets(cfg: DualARConfig, device=None) -> torch.Tensor:
    """Offsets into the fast input embedding table for the teacher-forced
    codes c_1..c_{n-1} [max_fast_seqlen - 1] (zeros unless depthwise_wte)."""
    if not cfg.depthwise_wte:
        return torch.zeros((cfg.max_fast_seqlen - 1,), dtype=torch.int64, device=device)
    offs = torch.arange(cfg.num_codebooks - 1, dtype=torch.int64, device=device) * cfg.codebook_size
    return offs if cfg.duplicate_code_0 else offs[1:]


def _init_trunk(gen, n_layer, dims: AttnDims, intermediate, std, qkv_bias, dtype):
    total_qkv = dims.q_size + 2 * dims.kv_size

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).to(dtype)

    lp = {
        "attention_norm": torch.ones((n_layer, dims.dim), dtype=dtype),
        "ffn_norm": torch.ones((n_layer, dims.dim), dtype=dtype),
        "wqkv": normal((n_layer, dims.dim, total_qkv)),
        "wo": normal((n_layer, dims.dim, dims.dim)),
        "w1": normal((n_layer, dims.dim, intermediate)),
        "w3": normal((n_layer, dims.dim, intermediate)),
        "w2": normal((n_layer, intermediate, dims.dim)),
    }
    if qkv_bias:
        lp["wqkv_bias"] = torch.zeros((n_layer, total_qkv), dtype=dtype)
    return lp


def init_params(
    cfg: DualARConfig,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
    device=None,
) -> DualARParams:
    """Random init: normal(0, initializer_range) weights, ones for norms,
    zero biases, the same shapes as the JAX package's `init_params`. The
    draws run on a CPU generator (seed 0 unless given), then move to
    `device` (None means CUDA)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    std = cfg.initializer_range

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).to(dtype)

    params: DualARParams = {
        "embeddings": normal((cfg.vocab_size, cfg.dim)),
        "codebook_embeddings": normal((cfg.codebook_size * cfg.num_codebooks, cfg.dim)),
        "layers": _init_trunk(
            gen, cfg.n_layer, slow_dims(cfg), cfg.intermediate_size, std,
            cfg.attention_qkv_bias, dtype,
        ),
        "norm": torch.ones((cfg.dim,), dtype=dtype),
        "fast_embeddings": normal((cfg.fast_embedding_rows, cfg.fast_dim)),
        "fast_layers": _init_trunk(
            gen, cfg.n_fast_layer, fast_dims(cfg), cfg.fast_intermediate_size, std,
            bool(cfg.fast_attention_qkv_bias), dtype,
        ),
        "fast_norm": torch.ones((cfg.fast_dim,), dtype=dtype),
    }
    if not cfg.tie_word_embeddings:
        params["output"] = normal((cfg.dim, cfg.vocab_size))
    if cfg.fast_dim != cfg.dim:
        params["fast_project_in"] = {
            "kernel": normal((cfg.dim, cfg.fast_dim)),
            "bias": torch.zeros((cfg.fast_dim,), dtype=dtype),
        }
    if cfg.depthwise_output:
        params["fast_output"] = normal((cfg.max_fast_seqlen, cfg.fast_dim, cfg.codebook_size))
    else:
        params["fast_output"] = normal((cfg.fast_dim, cfg.codebook_size))
    return tree_map(lambda t: t.to(dev), params)


class DualARDecoder(TensorTree):
    """The DualAR parameter tree as an `nn.Module` (`.to(device)`,
    `state_dict()`); `.tree()` gives the dict the decode functions take."""


def embed_merge(
    params: DualARParams,
    cfg: DualARConfig,
    tokens: torch.Tensor,  # [B, num_rows, T]
    *,
    embed_mask_mode: str = "row1_zero",
    semantic_start_id: int = 0,
    semantic_end_id: int = 0,
    mesh=None,
) -> torch.Tensor:
    """Row-0 text embedding plus the sum of per-level codebook embeddings,
    the latter zeroed on positions the mask mode excludes. Returns [B, T, dim].

    A `codebook_embeddings` table split by rows over the `mesh`'s model axis
    is looked up vocab-parallel (`_lookup`)."""
    tokens = tokens.long()
    text_tokens = tokens[:, 0, :]
    text_embeds = params["embeddings"][text_tokens]
    offs = semantic_offsets(cfg, tokens.device)
    cb_tokens = tokens[:, 1:, :] + offs[None, :, None]
    cb_sum = _lookup(params["codebook_embeddings"], cb_tokens,
                     cfg.codebook_size * cfg.num_codebooks, mesh, sum_dim=1)
    if embed_mask_mode == "row1_zero":
        keep = tokens[:, 1, :] != 0
    elif embed_mask_mode == "semantic_range":
        keep = (text_tokens >= semantic_start_id) & (text_tokens <= semantic_end_id)
    else:
        raise ValueError(f"unknown embed_mask_mode: {embed_mask_mode}")
    cb_sum = torch.where(keep[..., None], cb_sum, torch.zeros_like(cb_sum))
    return text_embeds + cb_sum


def token_head(params: DualARParams, cfg: DualARConfig, x: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """Vocab logits from the normed slow output (tied or separate head). A
    separate head split by columns over the `mesh`'s model axis gives its
    slice, gathered over that axis."""
    slow_out = rms_norm(x, params["norm"], cfg.norm_eps)
    if cfg.tie_word_embeddings:
        return slow_out @ params["embeddings"].T
    w = params["output"]
    if mesh is None or (w.q if isinstance(w, QTensor) else w).shape[-1] == cfg.vocab_size:
        return mm(slow_out, w)
    return gather_model(mm(copy_model(slow_out, mesh), w), mesh, -1)


def project_fast_in(params: DualARParams, cfg: DualARConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.fast_dim != cfg.dim:
        p = params["fast_project_in"]
        return mm(x, p["kernel"]) + p["bias"]
    return x


# ---- training forward -----------------------------------------------------

def run_trunk(layer_params: dict, x: torch.Tensor, dims: AttnDims, cos, sin, *, mask=None,
              is_causal: bool = True, dropout_rate: float = 0.0,
              dropout_seed: Optional[int] = None, dropout_cols: Optional[int] = None,
              norm_eps: float = 1e-5, remat: bool = False,
              remat_policy: str = "none", shard: Shard = WHOLE) -> torch.Tensor:
    """The stacked layers in order (JAX's lax.scan over the layer axis);
    layer i draws dropout from fold_in(seed, i). `remat` checkpoints each
    layer (torch.utils.checkpoint, use_reentrant=False). `shard`: how the
    layers lie on a mesh (layers.py::Shard)."""
    use_dropout = dropout_rate > 0.0 and dropout_seed is not None
    n_layer = layer_params["attention_norm"].shape[0]
    for i in range(n_layer):
        lp = {name: qindex(w, i) for name, w in layer_params.items()}
        seed = fold_in(dropout_seed, i) if use_dropout else None

        def block(x, lp, seed=seed):
            return transformer_block(x, lp, dims, cos, sin, mask=mask, is_causal=is_causal,
                                     dropout_rate=dropout_rate if use_dropout else 0.0,
                                     dropout_seed=seed, dropout_cols=dropout_cols,
                                     norm_eps=norm_eps, shard=shard)

        x = remat_call(block, x, lp, remat_policy=remat_policy) if remat else block(x, lp)
    return x


def fast_fold(N: int, n: int) -> int:
    """Frames folded into one fast sequence: the largest F of {16, 8, 4, 2}
    (at most SMOLTTS_FAST_FOLD, default 16) dividing N with F * n a multiple
    of 128; 1 when none does (SMOLTTS_FAST_FOLD=1 disables folding)."""
    fold_max = int(os.environ.get("SMOLTTS_FAST_FOLD", "16"))
    for cand in (16, 8, 4, 2):
        if cand <= fold_max and N % cand == 0 and (cand * n) % 128 == 0:
            return cand
    return 1


def run_fast_trunk(params: DualARParams, cfg: DualARConfig, fast_seq: torch.Tensor, *,
                   dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                   remat: bool = False, remat_policy: str = "none", mesh=None) -> torch.Tensor:
    """Fast trunk over per-frame sequences [N, n, fast_dim], F frames folded
    into one (F * n)-token sequence under a block-diagonal causal mask: each
    token still attends only within its frame, so the result equals the
    unfolded form; dropout draws one bit per (row, column class mod n).

    On a `mesh` the N frames are this data rank's share, batch-major, of
    N * n_data: F, and with it the dropout mask's layout, come from the
    global count, and a rank folds its own frames by F where F divides them."""
    N, n, fd = fast_seq.shape
    F = fast_fold(N, n)
    fdims, shard = fast_dims(cfg), WHOLE
    if mesh is not None:
        N_all = N * mesh.n_data
        F_all = fast_fold(N_all, n)
        F = F_all if N % F_all == 0 else F
        fdims, shard = trunk_shard(
            fdims, params["fast_layers"], mesh, N_all, mesh.data * N,
            window=lambda **kw: FoldWindow(**kw, F=F_all, n=n))
    fcos, fsin = rope_cos_sin(torch.arange(n, device=fast_seq.device), cfg.fast_head_dim,
                              cfg.rope_base)
    common = dict(dropout_rate=dropout_rate, dropout_seed=dropout_seed, norm_eps=cfg.norm_eps,
                  remat=remat, remat_policy=remat_policy, shard=shard)
    if F == 1:
        return run_trunk(params["fast_layers"], fast_seq, fdims, fcos, fsin, is_causal=True,
                         **common)
    folded = fast_seq.reshape(N // F, F * n, fd)
    idx = torch.arange(F * n, device=fast_seq.device)
    blk = idx // n
    fmask = (blk[:, None] == blk[None, :]) & (idx[:, None] >= idx[None, :])
    fast_x = run_trunk(params["fast_layers"], folded, fdims, fcos.repeat(F, 1),
                       fsin.repeat(F, 1), mask=fmask, is_causal=False, dropout_cols=n, **common)
    return fast_x.reshape(N, n, -1)


def fast_output_logits(params: DualARParams, cfg: DualARConfig,
                       fast_out: torch.Tensor, mesh=None) -> torch.Tensor:
    """[N, max_fast_seqlen, fast_dim] -> [N, max_fast_seqlen, codebook_size];
    the depthwise head is one [fast_dim, cb] projection per position, summed
    in f32 and rounded once (an int8 head is scaled before the rounding, as
    JAX does). A head split by codebook columns over the `mesh`'s model axis
    gives its slice, gathered over that axis."""
    w = params["fast_output"]
    split = mesh is not None and (w.q if isinstance(w, QTensor) else w).shape[-1] != cfg.codebook_size
    if split:
        fast_out = copy_model(fast_out, mesh)
    if not cfg.depthwise_output:
        y = mm(fast_out, w)
    elif isinstance(w, QTensor):
        y = torch.einsum("ijm,jmk->ijk", fast_out.float(), w.q.float())
        y = (y * w.scale.transpose(0, 1)).to(fast_out.dtype)  # scale [n, 1, cb]
    else:
        y = torch.einsum("ijm,jmk->ijk", fast_out, w)
    return gather_model(y, mesh, -1) if split else y


def fast_inputs(params: DualARParams, cfg: DualARConfig, h: torch.Tensor, codes: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """The fast trunk's inputs [B, T, n, fast_dim]: the projected slow state,
    then the embeddings of the teacher-forced codes [B, T, n - 1] (a table
    split by rows over the mesh's model axis looked up vocab-parallel)."""
    emb = _lookup(params["fast_embeddings"], codes, cfg.fast_embedding_rows, mesh)
    return torch.cat([h[:, :, None], emb], dim=2)


def _slow_forward(params: DualARParams, cfg: DualARConfig, tokens: torch.Tensor, *,
                  dropout: float, dropout_seed: Optional[int], embed_mask_mode: str,
                  semantic_start_id: int, semantic_end_id: int, activation_sharding,
                  remat_policy: str, remat: bool, mesh=None) -> torch.Tensor:
    """Embed-merge + slow trunk -> pre-norm hidden states [B, T, dim].

    `activation_sharding` SEQUENCE_SHARDING on a mesh with a model axis is
    sequence parallelism: the trunk's residual stream holds this rank's
    T / n_model rows (RoPE positions and the causal mask at their global
    offset, the attention route chosen by the whole T), and the result is
    gathered back to [B, T, dim] on every rank. With one rank on the model
    axis, or no mesh, every rank holds every row already."""
    if activation_sharding is not None and tuple(activation_sharding) != SEQUENCE_SHARDING:
        raise ValueError(f"activation_sharding {activation_sharding!r}: the slow trunk's "
                         f"activations lie as {SEQUENCE_SHARDING} or whole (None)")
    x = embed_merge(params, cfg, tokens, embed_mask_mode=embed_mask_mode,
                    semantic_start_id=semantic_start_id, semantic_end_id=semantic_end_id,
                    mesh=mesh)
    B, T = tokens.shape[0], tokens.shape[-1]
    dims, shard, positions = slow_dims(cfg), WHOLE, torch.arange(T, device=tokens.device)
    if mesh is not None:
        seq = activation_sharding is not None and mesh.n_model > 1
        dims, shard = trunk_shard(dims, params["layers"], mesh, B * mesh.n_data, mesh.data * B,
                                  seq=seq)
        if seq:
            if T % mesh.n_model:
                raise ValueError(f"sequence parallelism: T {T} does not split over "
                                 f"{mesh.n_model} model ranks")
            x = scatter_model(x, mesh, 1)
            if not shard.split:  # the rank's queries and keys are its rows
                positions = positions.narrow(0, mesh.model * x.shape[1], x.shape[1])
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
    x = run_trunk(params["layers"], x, dims, cos, sin, is_causal=True,
                  dropout_rate=dropout, dropout_seed=dropout_seed, norm_eps=cfg.norm_eps,
                  remat=remat, remat_policy=remat_policy, shard=shard)
    return gather_model(x, mesh, 1) if shard.seq else x


def remat_scopes(cfg: DualARConfig, train: bool):
    """(slow, fast): whether layer remat applies to each trunk. Remat is on
    when the config asks for gradient checkpointing and `train`;
    SMOLTTS_REMAT_SCOPE (both | slow | fast, default both) picks the trunks."""
    scope = os.environ.get("SMOLTTS_REMAT_SCOPE", "both")
    on = cfg.use_gradient_checkpointing and train
    return on and scope in ("both", "slow"), on and scope in ("both", "fast")


def teacher_forced_codes(cfg: DualARConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Next-frame codebook rows 1..R-2, shifted left in time, zero-padded at
    the end, with the fast table's offsets: [B, T, R-2] int64 (time-major)."""
    cb = torch.nn.functional.pad(tokens[:, 1:-1, 1:].long(), (0, 1))
    cb = cb + fast_codebook_offsets(cfg, tokens.device)[None, :, None]
    return cb.transpose(1, 2)


def forward_train(params: DualARParams, cfg: DualARConfig, tokens: torch.Tensor, *,
                  dropout_seed: Optional[int] = None, train: bool = False,
                  embed_mask_mode: str = "row1_zero", semantic_start_id: int = 0,
                  semantic_end_id: int = 0, activation_sharding=None,
                  remat_policy: str = "none", mesh=None) -> TrainForwardResult:
    """Training forward: slow trunk, token head, then the fast trunk dense
    over every frame on teacher-forced codes. tokens int [B, num_rows, T],
    already shifted (input side). Dropout applies when `train` and a seed is
    given. On a `mesh`: this data rank's B rows, on its part of the tree."""
    B, R, T = tokens.shape
    if R != cfg.num_rows:
        raise ValueError(f"expected {cfg.num_rows} rows, got {R}")
    dropout = cfg.dropout if train else 0.0
    seeds = split_seed(dropout_seed) if (dropout > 0.0 and dropout_seed is not None) else (None, None)
    remat_slow, remat_fast = remat_scopes(cfg, train)

    x = _slow_forward(params, cfg, tokens, dropout=dropout, dropout_seed=seeds[0],
                      embed_mask_mode=embed_mask_mode, semantic_start_id=semantic_start_id,
                      semantic_end_id=semantic_end_id, activation_sharding=activation_sharding,
                      remat_policy=remat_policy, remat=remat_slow, mesh=mesh)
    token_logits = token_head(params, cfg, x, mesh)

    h = project_fast_in(params, cfg, x)  # [B, T, fast_dim]
    fast_seq = fast_inputs(params, cfg, h, teacher_forced_codes(cfg, tokens), mesh)
    n = cfg.max_fast_seqlen
    fast_x = run_fast_trunk(params, cfg, fast_seq.reshape(B * T, n, cfg.fast_dim),
                            dropout_rate=dropout, dropout_seed=seeds[1], remat=remat_fast,
                            remat_policy=remat_policy, mesh=mesh)
    fast_out = rms_norm(fast_x, params["fast_norm"], cfg.norm_eps)
    codebook_logits = fast_output_logits(params, cfg, fast_out, mesh).reshape(
        B, T, n, cfg.codebook_size)
    return TrainForwardResult(token_logits=token_logits, codebook_logits=codebook_logits,
                              hidden_states=x)
