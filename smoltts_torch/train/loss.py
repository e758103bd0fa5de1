"""DualAR training losses: `base` is the CE of the slow head against row-0
labels, `semantic` the CE over all codebook levels flattened together, both
masked where labels are -100, in f32; optional per-codebook losses.
`forward_train_loss` fuses the fast trunk and the codebook CE, chunked over
time, so the [B, T, n, codebook_size] logits are never held.

On a mesh each data rank holds its rows of the batch. A mean is the JAX
package's one masked mean over the global batch: the NLL sums and the
valid-token counts are summed over the data axis and divided once, not
averaged per rank. The value is the global mean on every rank; its gradient
is this rank's share of the global gradient, so the step sums the
gradients over the data axis."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from smoltts_torch.models.dual_ar import (
    _slow_forward,
    fast_inputs,
    fast_output_logits,
    forward_train,
    project_fast_in,
    run_fast_trunk,
    teacher_forced_codes,
    token_head,
)
from smoltts_torch.models.layers import fold_in, remat_call, rms_norm, split_seed
from smoltts_torch.parallel.collectives import reduce_data, sum_data

IGNORE_INDEX = -100


class Losses(NamedTuple):
    total: torch.Tensor
    base: torch.Tensor
    semantic: torch.Tensor
    per_codebook: Optional[torch.Tensor] = None  # [num_levels]


def _nll(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX):
    """(masked NLL per position, mask) with the log-softmax in f32."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return nll * mask, mask


def global_mean(total: torch.Tensor, count: torch.Tensor, mesh=None) -> torch.Tensor:
    """total / max(count, 1), each summed over the mesh's data axis first
    (the count with no gradient)."""
    return reduce_data(total, mesh) / sum_data(count, mesh).clamp(min=1)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = IGNORE_INDEX, mesh=None) -> torch.Tensor:
    """Mean CE over positions where labels != ignore_index (0 if none),
    over the global batch on a `mesh`. logits [..., V]; labels [...]."""
    nll, mask = _nll(logits, labels, ignore_index)
    return global_mean(nll.sum(), mask.sum(), mesh)


def compute_losses(token_logits: torch.Tensor, codebook_logits: torch.Tensor,
                   labels: torch.Tensor, per_codebook: bool = False, mesh=None) -> Losses:
    """token_logits [B, T, V]; codebook_logits [B, T, N, CB]; labels [B, 1 + N, T]."""
    base = masked_cross_entropy(token_logits, labels[:, 0, :], mesh=mesh)
    cb_labels = labels[:, 1:, :].transpose(1, 2)  # [B, T, N]
    semantic = masked_cross_entropy(codebook_logits, cb_labels, mesh=mesh)
    per_cb = None
    if per_codebook:
        per_cb = torch.stack([masked_cross_entropy(codebook_logits[:, :, i], cb_labels[:, :, i],
                                                   mesh=mesh)
                              for i in range(cb_labels.shape[-1])])
    return Losses(total=base + semantic, base=base, semantic=semantic, per_codebook=per_cb)


def _masked_nll_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(sum NLL, count) per level over labels != -100; logits [..., N, CB],
    labels [..., N] -> [N], [N]."""
    nll, mask = _nll(logits, labels)
    axes = tuple(range(nll.dim() - 1))
    return nll.sum(dim=axes), mask.sum(dim=axes)


def forward_train_loss(params, cfg, tokens: torch.Tensor, labels: torch.Tensor, *,
                       dropout_seed: Optional[int] = None, train: bool = False,
                       chunk_t: int = 0, per_codebook: bool = False,
                       embed_mask_mode: str = "row1_zero", semantic_start_id: int = 0,
                       semantic_end_id: int = 0, activation_sharding=None,
                       remat_policy: str = "none", mesh=None) -> Losses:
    """Forward + losses, with the fast trunk, depthwise head and codebook CE
    run per chunk of `chunk_t` slow positions, each chunk checkpointed when
    remat is on (backward recomputes one chunk at a time); chunk c draws
    dropout from fold_in(seed, c). Equal to forward_train + compute_losses.
    chunk_t=0 is the dense path. `mesh`: as forward_train's, the means
    global."""
    if chunk_t <= 0:
        out = forward_train(params, cfg, tokens, dropout_seed=dropout_seed, train=train,
                            embed_mask_mode=embed_mask_mode,
                            semantic_start_id=semantic_start_id,
                            semantic_end_id=semantic_end_id,
                            activation_sharding=activation_sharding, remat_policy=remat_policy,
                            mesh=mesh)
        return compute_losses(out.token_logits, out.codebook_logits, labels,
                              per_codebook=per_codebook, mesh=mesh)

    B, R, T = tokens.shape
    if T % chunk_t:
        raise ValueError(f"fast_chunk_t {chunk_t} must divide T {T}")
    n = cfg.max_fast_seqlen
    dropout = cfg.dropout if train else 0.0
    use_dropout = dropout > 0.0 and dropout_seed is not None
    seeds = split_seed(dropout_seed) if use_dropout else (None, None)
    remat = cfg.use_gradient_checkpointing and train

    x = _slow_forward(params, cfg, tokens, dropout=dropout, dropout_seed=seeds[0],
                      embed_mask_mode=embed_mask_mode, semantic_start_id=semantic_start_id,
                      semantic_end_id=semantic_end_id, activation_sharding=activation_sharding,
                      remat_policy=remat_policy, remat=remat, mesh=mesh)
    base = masked_cross_entropy(token_head(params, cfg, x, mesh), labels[:, 0, :], mesh=mesh)

    h = project_fast_in(params, cfg, x)  # [B, T, fast_dim]
    cb = teacher_forced_codes(cfg, tokens)  # [B, T, n-1]
    cb_labels = labels[:, 1:, :].transpose(1, 2)  # [B, T, n]

    def chunk_body(hc, cbc, lbc, seed):
        seq = fast_inputs(params, cfg, hc, cbc, mesh)
        # no per-layer remat inside: the chunk itself is checkpointed
        fast_x = run_fast_trunk(params, cfg, seq.reshape(B * chunk_t, n, -1),
                                dropout_rate=dropout if use_dropout else 0.0,
                                dropout_seed=seed, remat=False, remat_policy=remat_policy,
                                mesh=mesh)
        fast_out = rms_norm(fast_x, params["fast_norm"], cfg.norm_eps)
        logits = fast_output_logits(params, cfg, fast_out, mesh)  # [B*C, n, CB]
        return _masked_nll_sums(logits, lbc.reshape(B * chunk_t, n))

    nll = torch.zeros((n,), dtype=torch.float32, device=tokens.device)
    cnt = torch.zeros((n,), dtype=torch.int64, device=tokens.device)
    for c in range(T // chunk_t):
        sl = slice(c * chunk_t, (c + 1) * chunk_t)
        seed = fold_in(seeds[1], c) if use_dropout else None
        args = (h[:, sl], cb[:, sl], cb_labels[:, sl])
        if remat:
            s, k = remat_call(lambda *a, seed=seed: chunk_body(*a, seed), *args,
                              remat_policy=remat_policy)
        else:
            s, k = chunk_body(*args, seed)
        nll, cnt = nll + s, cnt + k
    if mesh is not None:
        nll, cnt = reduce_data(nll, mesh), sum_data(cnt, mesh)
    semantic = nll.sum() / cnt.sum().clamp(min=1)
    per_cb = nll / cnt.clamp(min=1) if per_codebook else None
    return Losses(total=base + semantic, base=base, semantic=semantic, per_codebook=per_cb)
