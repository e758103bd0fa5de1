"""Train step and loop for DualAR models, on one device or a mesh.

The step is forward + backward through `loss_fn`, gradient accumulation
over a leading micro-batch axis (the sum kept in f32, divided by the count),
then the port's AdamW (train/optim.py), which updates the parameters in
place. Randomness is an integer seed per step, drawn by `train_loop` from an
explicit `torch.Generator` and split per micro-batch, as the JAX loop splits
its key; the forward folds it into one seed per dropout site, so activation
checkpointing recomputes the same masks.

On a mesh (parallel/mesh.py) each rank steps its part of the tree
(`shard_params`) on its data coordinate's rows: the losses are global means,
the gradients are summed over the data axis (one all-reduce per dtype), and
every rank draws the same seed each step, the dropout masks being drawn at
the global shape.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig, TrainingConfig
from smoltts_torch.models.dual_ar import forward_train
from smoltts_torch.models.layers import split_seed
from smoltts_torch.parallel.collectives import sum_data_flat
from smoltts_torch.parallel.mesh import SEQUENCE_SHARDING
from smoltts_torch.train.loss import Losses, compute_losses, forward_train_loss
from smoltts_torch.train.optim import AdamW, create_optimizer, tree_leaves
from smoltts_torch.utils.profiling import trace


class TrainState(NamedTuple):
    params: Any  # the parameter tree; its leaves are updated in place
    opt_state: AdamW  # holds the moments and the update count
    step: int


def init_train_state(params, config: TrainingConfig, mesh=None, shard_tables: bool = False):
    """(TrainState at step 0, the optimizer); the optimizer is also the
    state's `opt_state`. On a `mesh`, `params` is this rank's part under
    `param_partition_specs(..., shard_tables)`."""
    tx = create_optimizer(config, params, mesh, shard_tables)
    return TrainState(params=params, opt_state=tx, step=0), tx


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch arrays as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_fn(params, cfg: DualARConfig, batch: Dict[str, torch.Tensor], seed: Optional[int],
            remat_policy: str = "none", activation_sharding=None, fast_chunk_t: int = 0,
            mesh=None):
    """(total loss, Losses) of one training forward with dropout."""
    losses = forward_train_loss(params, cfg, batch["tokens"], batch["labels"], dropout_seed=seed,
                                train=True, chunk_t=fast_chunk_t, remat_policy=remat_policy,
                                activation_sharding=activation_sharding, mesh=mesh)
    return losses.total, losses


def make_train_step(cfg: DualARConfig, config: TrainingConfig, tx: AdamW,
                    accumulate_steps: int = 1, activation_sharding=None, mesh=None):
    """step(state, batch, seed) -> (state', metrics). With accumulate_steps >
    1 the batch arrays carry a leading micro-batch axis ([A, B, R, T]). On a
    `mesh`, the batch is this rank's rows of the data axis (`make_global_batch`)
    and `tx` holds this rank's leaves (`init_train_state(..., mesh)`)."""
    leaves = tx.param_groups[0]["params"]

    def grads_of(params, batch, seed):
        total, losses = loss_fn(params, cfg, batch, seed, config.remat_policy,
                                activation_sharding, config.fast_chunk_t, mesh)
        grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
        return grads, losses

    def step_fn(state: TrainState, batch, seed: Optional[int]):
        batch = batch_to(batch, leaves[0].device)
        if accumulate_steps == 1:
            grads, losses = grads_of(state.params, batch, seed)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            seq = []
            for a in range(accumulate_steps):
                seed, sub = split_seed(seed) if seed is not None else (None, None)
                g, losses = grads_of(state.params, {k: v[a] for k, v in batch.items()}, sub)
                for s, gi in zip(acc, g):
                    s += gi
                seq.append(losses)
            grads = [s / accumulate_steps for s in acc]
            losses = Losses(*(torch.stack([getattr(l, f) for l in seq]).mean()
                              for f in ("total", "base", "semantic")))
        grad_norm = tx.step(sum_data_flat(grads, mesh))
        metrics = {"loss": losses.total.detach(), "base_loss": losses.base.detach(),
                   "semantic_loss": losses.semantic.detach(), "grad_norm": grad_norm}
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step_fn


def make_eval_step(cfg: DualARConfig, mesh=None):
    """eval(params, batch) -> Losses with per-codebook losses, global means
    on a `mesh` (the batch this rank's rows)."""
    @torch.no_grad()
    def eval_fn(params, batch) -> Losses:
        batch = batch_to(batch, tree_leaves(params)[0].device)
        out = forward_train(params, cfg, batch["tokens"], train=False, mesh=mesh)
        return compute_losses(out.token_logits, out.codebook_logits, batch["labels"],
                              per_codebook=True, mesh=mesh)

    return eval_fn


def validate(params, cfg: DualARConfig, val_batches, eval_step=None,
             mesh=None) -> Dict[str, float]:
    """Losses averaged over the validation batches (each a global mean on a
    `mesh`)."""
    eval_step = eval_step or make_eval_step(cfg, mesh)
    totals, n = None, 0
    for batch in val_batches:
        losses = [np.asarray(x.detach().cpu()) for x in eval_step(params, batch)]
        totals = losses if totals is None else [a + b for a, b in zip(totals, losses)]
        n += 1
    if totals is None:
        return {}
    out = {"loss": float(totals[0]) / n, "base_loss": float(totals[1]) / n,
           "semantic_loss": float(totals[2]) / n}
    for i, v in enumerate(totals[3] / n):
        out[f"codebook_{i + 1}_loss"] = float(v)
    return out


def train_loop(cfg: DualARConfig, config: TrainingConfig, state: TrainState, tx: AdamW,
               train_batches, val_batches_fn=None, checkpoint_manager=None, log_fn=None,
               generator: Optional[torch.Generator] = None, max_steps: Optional[int] = None,
               device=None, mesh=None) -> TrainState:
    """Iterate batches: step, log every `log_every_n_steps`, validate every
    `val_every_n_steps`, save every `save_every_n_steps`. `device=None`
    means CUDA; the state's parameters must live there. With profile_steps
    > 0, steps [2, 2 + profile_steps) are traced by `utils.profiling.trace`
    into profile_dir. On a `mesh` (every rank calls it with its own batches, its
    part of the state and the same generator), `sequence_parallel` splits
    the slow trunk's activations as SEQUENCE_SHARDING; without a mesh it
    does nothing, as JAX's loop wires it only for parameters on a mesh."""
    dev = resolve_device(device)
    p0 = tree_leaves(state.params)[0]
    if p0.device.type != dev.type:
        raise ValueError(f"parameters on {p0.device}, train_loop asked for {dev}")
    generator = generator if generator is not None else torch.Generator().manual_seed(config.seed)
    sharding = SEQUENCE_SHARDING if config.sequence_parallel and mesh is not None else None
    train_step = make_train_step(cfg, config, tx, accumulate_steps=config.accumulate_steps,
                                 activation_sharding=sharding, mesh=mesh)
    t0 = time.perf_counter()
    prof = None
    for i, batch in enumerate(train_batches):
        if max_steps is not None and i >= max_steps:
            break
        if config.profile_steps > 0:
            if i == 2 and prof is None:
                prof = contextlib.ExitStack()
                prof.enter_context(trace(config.profile_dir))
            elif prof is not None and i >= 2 + config.profile_steps:
                prof.close()
                prof = None
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        state, metrics = train_step(state, batch, seed)
        step = state.step

        if log_fn and step % config.log_every_n_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_s"] = config.log_every_n_steps / max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            log_fn(step, m)
        if val_batches_fn and step % config.val_every_n_steps == 0 and step > 0:
            vm = validate(state.params, cfg, val_batches_fn(), mesh=mesh)
            if log_fn:
                log_fn(step, {f"val/{k}": v for k, v in vm.items()})
        if checkpoint_manager and step % config.save_every_n_steps == 0 and step > 0:
            checkpoint_manager.save(state, step)
    if prof is not None:
        prof.close()
    return state
