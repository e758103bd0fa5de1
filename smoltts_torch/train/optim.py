"""AdamW with warmup and global-norm clipping, repeating optax's arithmetic
(the JAX package's `optax.chain(clip_by_global_norm, adamw(mask=...,
mu_dtype=f32))`), not torch.optim.AdamW's:

- the first moment is kept in f32, the second in the gradient's dtype
  (bf16 for bf16 params and no accumulation);
- weight decay adds wd * p to the Adam update before the learning-rate
  scale (torch.optim.AdamW instead multiplies p by 1 - lr * wd first);
- the global norm is sqrt(sum over leaves of sum(g * g)) in each leaf's
  dtype, with no epsilon;
- update k (counted from 0) uses lr_schedule(k);
- biases and norm weights are not decayed; embedding tables are (the
  reference's exemption pattern never matches their names).

On a mesh (parallel/mesh.py) the optimizer holds this rank's leaves. The
gradients come in summed over the data axis; the global norm sums a split
leaf's squares over the model axis and counts a replicated leaf once, so
every rank clips by the same norm, and the elementwise update runs on the
local leaves unchanged.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from smoltts_torch.config import TrainingConfig
from smoltts_torch.parallel.collectives import sum_model
from smoltts_torch.parallel.mesh import MODEL_AXIS, param_partition_specs

_NO_DECAY_LEAVES = {
    "attention_norm",
    "ffn_norm",
    "norm",
    "fast_norm",
    "wqkv_bias",
    "bias",
}


def decay_mask(params) -> dict:
    """The tree of bools: True where weight decay applies."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return name not in _NO_DECAY_LEAVES

    return walk(params, "")


def tree_leaves(tree) -> List:
    """Leaves in JAX's pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves: Sequence):
    """The tree shaped as `template` with `leaves` in `tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def split_leaves(params, mesh=None, shard_tables: bool = False) -> Optional[List[bool]]:
    """Per leaf (`tree_leaves` order), whether this rank holds a share of it
    split over the mesh's model axis; None without a model axis."""
    if mesh is None or mesh.n_model == 1:
        return None
    return [MODEL_AXIS in spec
            for spec in tree_leaves(param_partition_specs(params, shard_tables))]


def lr_schedule(config: TrainingConfig) -> Callable[[int], np.float32]:
    """Linear lr_start -> learning_rate over the warmup, then constant; in
    f32, as JAX evaluates it."""
    start = np.float32(config.lr_start)
    span = np.float32(config.learning_rate - config.lr_start)
    warmup = np.float32(max(1, config.lr_warmup_steps))

    def fn(step: int) -> np.float32:
        progress = min(np.float32(step) / warmup, np.float32(1.0))
        return np.float32(start + span * progress)

    return fn


def _sum_squares(grads):
    total = None
    for g in grads:
        s = torch.sum(g * g)
        total = s if total is None else total + s
    return total


def global_norm(grads: Sequence[torch.Tensor], mesh=None,
                split: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """optax.global_norm: each leaf's sum of squares in its dtype, summed in
    leaf order. On a `mesh`, `split` flags the leaves this rank holds a share
    of (`split_leaves`): their squares are summed over the model axis, each
    replicated leaf counted once."""
    grads = list(grads)
    if split is None:
        return torch.sqrt(_sum_squares(grads))
    mine = _sum_squares([g for g, s in zip(grads, split, strict=True) if s])
    total = _sum_squares([g for g, s in zip(grads, split) if not s])
    if mine is not None:
        mine = sum_model(mine, mesh)
        total = mine if total is None else mine + total
    return torch.sqrt(total)


class AdamW(torch.optim.Optimizer):
    """One param group; per parameter: `mu` (f32), `nu` and its `decay`
    flag; the update count is `param_groups[0]["count"]`. `step(grads)`
    takes the gradients in parameter order (or reads `.grad`) and returns
    their global norm before clipping. On a `mesh`, the parameters are a
    rank's leaves and `split` flags those split over the model axis."""

    def __init__(self, params: Sequence[torch.Tensor], decay: Sequence[bool],
                 config: TrainingConfig, mesh=None, split: Optional[Sequence[bool]] = None):
        params = list(params)
        super().__init__(params, dict(
            lr=config.learning_rate, betas=tuple(config.betas), eps=config.eps,
            weight_decay=config.weight_decay, gradient_clip=config.gradient_clip, count=0))
        self.schedule = lr_schedule(config)
        self.mesh, self.split = mesh, None if split is None else list(split)
        for p, d in zip(params, decay, strict=True):
            self.state[p] = {"mu": torch.zeros_like(p, dtype=torch.float32),
                             "nu": torch.zeros_like(p), "decay": bool(d)}

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's loader, then the moments as saved: torch casts a
        floating-point state to its parameter's dtype, which would round the
        f32 first moment of a bf16 parameter (optax keeps it f32)."""
        super().load_state_dict(state_dict)
        for i, p in enumerate(self.param_groups[0]["params"]):
            saved = state_dict["state"][i]
            for k in ("mu", "nu"):
                self.state[p][k] = saved[k].to(device=p.device, copy=True)

    @torch.no_grad()
    def step(self, grads=None) -> torch.Tensor:
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad for p in params] if grads is None else list(grads)
        b1, b2 = group["betas"]
        eps, wd, clip = group["eps"], group["weight_decay"], group["gradient_clip"]
        g_norm = global_norm(grads, self.mesh, self.split)
        if clip > 0:
            trigger = g_norm < clip
            grads = [torch.where(trigger, g, (g / g_norm.to(g.dtype)) * clip) for g in grads]
        count = group["count"]
        count_inc = torch.tensor(count + 1, dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count_inc
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count_inc
        lr = -self.schedule(count)
        for p, g in zip(params, grads, strict=True):
            st = self.state[p]
            mu = ((1 - b1) * g + b1 * st["mu"]).float()
            nu = (1 - b2) * (g * g) + b2 * st["nu"]
            st["mu"], st["nu"] = mu, nu
            mu_hat = mu / bc1.to(device=mu.device)
            nu_hat = nu / bc2.to(device=nu.device, dtype=nu.dtype)
            upd = mu_hat / (torch.sqrt(nu_hat) + eps)
            if st["decay"]:
                upd = upd + wd * p
            upd = torch.tensor(lr, dtype=upd.dtype, device=upd.device) * upd
            p.copy_((p + upd).to(p.dtype))
        group["count"] = count + 1
        return g_norm


def create_optimizer(config: TrainingConfig, params, mesh=None,
                     shard_tables: bool = False) -> AdamW:
    """AdamW over the tree's leaves (JAX's leaf order) with the decay
    partition of `decay_mask`. The leaves are made to require grad. On a
    `mesh`, `params` is this rank's part under `param_partition_specs(...,
    shard_tables)`."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return AdamW(leaves, tree_leaves(decay_mask(params)), config, mesh,
                 split_leaves(params, mesh, shard_tables))

