"""smoltts-train, the training CLI, on one device or a mesh of processes:

    python -m smoltts_torch.train.main --config <json> [--checkpoint <step dir>]
        [--max-steps N] [--device cuda|cpu]
        [--multihost] [--coordinator host:port --num-processes N --process-id I]

JSON run config, dataset splits (an HF `datasets` directory), fresh init or a
pretrained checkpoint, resume (explicit or, with `auto_resume`, from the
newest step) with the optimizer reinitialized on hyperparameter drift, then
the loop with validation and checkpoints. `--device` defaults to CUDA.

With `--multihost` (torchrun's environment) or `--coordinator` (an explicit
address, world size and rank) every process joins one process group and
trains its part of a `mesh_data_axis` x `mesh_model_axis` mesh, one process
per device, as the JAX package's CLI trains over its devices: the
parameters split by `param_shardings`, each data rank reading its own
share of the `batch_size` rows its host feeds (the model ranks of a row
the same rows), checkpoints written from the shards by rank 0. Without a
process group the mesh must be 1 x 1.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
import torch.distributed as dist

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig, ModelType, load_training_config
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    make_multihost_mesh,
    mesh_shape,
    rank_device,
    shard_params,
)
from smoltts_torch.tokenizer import TokenConfig, load_tokenizer
from smoltts_torch.train.checkpoint import CheckpointManager, shard_opt_state
from smoltts_torch.train.data import batch_iterator, load_splits
from smoltts_torch.train.optim import tree_leaves
from smoltts_torch.train.trainer import TrainState, init_train_state, train_loop


def default_log_fn(use_wandb: bool):
    run = None
    if use_wandb:
        try:
            import wandb  # type: ignore

            run = wandb.init(project="smoltts_torch", resume="allow")
        except Exception as e:  # wandb absent or offline: log to stdout only
            print(f"wandb unavailable ({e}); falling back to stdout logging")

    def log(step: int, metrics: dict):
        if run is not None:
            run.log(metrics, step=step)
        line = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in metrics.items())
        print(f"step {step}: {line}")

    return log


def host_count() -> int:
    """Hosts in the process group (torchrun's LOCAL_WORLD_SIZE processes a
    host; one without it)."""
    world = dist.get_world_size()
    return world // int(os.environ.get("LOCAL_WORLD_SIZE", world))


def training_mesh(config, device):
    """The run's mesh: over every process of the group (hosts outermost,
    `make_multihost_mesh`, when there are several; else
    `make_mesh(mesh_data_axis, mesh_model_axis)`), or None for a process
    with no group, whose mesh must be 1 x 1."""
    if not dist.is_initialized():
        mesh_shape(config.mesh_data_axis, config.mesh_model_axis, 1)
        return None
    if host_count() > 1:
        return make_multihost_mesh(config.mesh_model_axis, device=device)
    return make_mesh(config.mesh_data_axis, config.mesh_model_axis, device=device)


def rank_batch_size(batch_size: int, mesh, hosts: int = 1) -> int:
    """The rows a data rank reads per step. `batch_size` keeps the JAX
    package's meaning, the batch one host feeds: it splits over the host's
    data ranks (on one host, every data rank of the mesh)."""
    n = 1 if mesh is None else mesh.n_data // hosts
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} does not split over {n} data ranks")
    return batch_size // n


def rank_batches(dataset, mesh, batch_size: int, accumulate_steps: int = 1, **kw):
    """This data rank's batches (`batch_iterator` with process_index
    mesh.data of n_data), each epoch cut to the windows every data rank
    has: the iterator gives a process past the first one window fewer an
    epoch when the last window is full, as the JAX package's does, and the
    ranks of one step must read one global window."""
    n_data = 1 if mesh is None else mesh.n_data
    data = 0 if mesh is None else mesh.data
    it = batch_iterator(dataset, batch_size=batch_size, accumulate_steps=accumulate_steps,
                        process_index=data, process_count=n_data, **kw)
    eff = batch_size * accumulate_steps
    last = len(dataset) - eff * n_data + 1
    mine, common = (len(range(p * eff, last, eff * n_data)) for p in (data, n_data - 1))
    for i, batch in enumerate(it):
        if i % mine < common:
            yield batch


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    # --multihost alone reads torchrun's environment; the explicit flags
    # give the group's address, size and this process's rank.
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--coordinator", type=str, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if args.multihost or args.coordinator is not None:
        init_distributed(args.coordinator, args.num_processes, args.process_id, device=dev)
    if dist.is_initialized():
        dev = rank_device(dev)

    config = load_training_config(args.config)
    mesh = training_mesh(config, dev)
    rows = rank_batch_size(config.batch_size, mesh, 1 if mesh is None else host_count())
    model_cfg = DualARConfig.from_json_file(config.init_folder)
    tokenizer = load_tokenizer(config.init_folder)
    token_cfg = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), tokenizer, model_cfg)
    # every rank must split the dataset alike
    train_ds, val_ds = load_splits(config.dataset_path,
                                   seed=None if mesh is None else config.seed)
    dtype = torch.bfloat16 if config.use_bf16 else torch.float32

    if config.use_pretrained:
        from smoltts_torch.io.checkpoint import load_params

        params = load_params(config.init_folder, model_cfg, dtype=dtype, device=dev)
    else:
        params = init_params(model_cfg, torch.Generator().manual_seed(config.seed), dtype=dtype,
                             device=dev)
    print(f"Total number of parameters: {sum(p.numel() for p in tree_leaves(params))}")

    checkpoint_manager = CheckpointManager(config.checkpoint_path,
                                           keep_last_n=config.keep_last_n_checkpoints,
                                           config=config, mesh=mesh, model_cfg=model_cfg)
    resume_from = args.checkpoint
    if resume_from is None and config.auto_resume:
        latest = CheckpointManager.latest_checkpoint(config.checkpoint_path)
        if mesh is not None:  # rank 0's pick, on every rank
            latest = mesh.broadcast_object(latest)
        if latest is not None:
            print(f"auto-resume: restarting from {latest}")
            resume_from = str(latest)
    start_step, opt_sd = 0, None
    if resume_from:
        ckpt, start_step, reinit = CheckpointManager.load(resume_from, config, map_location=dev,
                                                          mesh=mesh)
        params = ckpt["params"]
        if not reinit:
            opt_sd = ckpt["opt_state"] if mesh is None else shard_opt_state(
                ckpt["opt_state"], params, mesh, model_cfg)
    if mesh is not None:
        params = shard_params(params, mesh, cfg=model_cfg)
    state, tx = init_train_state(params, config, mesh=mesh)
    if opt_sd is not None:
        tx.load_state_dict(opt_sd)
    state = TrainState(state.params, state.opt_state, start_step)

    def batches():
        yield from rank_batches(
            train_ds, mesh, rows, config.accumulate_steps, semantic_pad_id=token_cfg.pad_id,
            max_len=config.max_sequence_length, duplicate_code_0=model_cfg.duplicate_code_0,
            num_codebooks=model_cfg.num_codebooks, seed=config.seed, epochs=config.max_epochs)

    def val_batches():
        it = rank_batches(
            val_ds, mesh, rows, semantic_pad_id=token_cfg.pad_id,
            max_len=config.max_sequence_length, duplicate_code_0=model_cfg.duplicate_code_0,
            num_codebooks=model_cfg.num_codebooks)
        for i, b in enumerate(it):
            if i >= 16:
                break
            yield b

    return train_loop(model_cfg, config, state, tx, batches(), val_batches_fn=val_batches,
                      checkpoint_manager=checkpoint_manager,
                      log_fn=default_log_fn(config.use_wandb),
                      generator=torch.Generator().manual_seed(config.seed),
                      max_steps=args.max_steps, device=dev, mesh=mesh)


if __name__ == "__main__":
    main()
