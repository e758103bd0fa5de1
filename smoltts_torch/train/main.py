"""smoltts-train, the training CLI, on one device:

    python -m smoltts_torch.train.main --config <json> [--checkpoint <step dir>]
        [--max-steps N] [--device cuda|cpu]

JSON run config, dataset splits (an HF `datasets` directory), fresh init or a
pretrained checkpoint, resume (explicit or, with `auto_resume`, from the
newest step) with the optimizer reinitialized on hyperparameter drift, then
the loop with validation and checkpoints. `--device` defaults to CUDA. A
mesh other than 1 x 1, sequence parallelism and multi-process runs wait for
ROADMAP A7.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig, ModelType, load_training_config
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.tokenizer import TokenConfig, load_tokenizer
from smoltts_torch.train.checkpoint import CheckpointManager
from smoltts_torch.train.data import batch_iterator, load_splits
from smoltts_torch.train.optim import tree_leaves
from smoltts_torch.train.trainer import TrainState, init_train_state, train_loop

_A7 = "waits for the port's parallel layer (ROADMAP A7); the port trains on one device"


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


def check_single_device(config, args) -> None:
    if args.multihost or args.coordinator is not None or args.num_processes not in (None, 1):
        raise NotImplementedError(f"multi-process training {_A7}")
    if config.mesh_model_axis != 1 or config.mesh_data_axis not in (-1, 1):
        raise NotImplementedError(f"mesh {config.mesh_data_axis} x {config.mesh_model_axis} {_A7}")
    if config.sequence_parallel:
        raise NotImplementedError(f"sequence_parallel {_A7}")


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--coordinator", type=str, default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    config = load_training_config(args.config)
    check_single_device(config, args)
    model_cfg = DualARConfig.from_json_file(config.init_folder)
    tokenizer = load_tokenizer(config.init_folder)
    token_cfg = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), tokenizer, model_cfg)
    train_ds, val_ds = load_splits(config.dataset_path)
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
                                           config=config)
    resume_from = args.checkpoint
    if resume_from is None and config.auto_resume:
        latest = CheckpointManager.latest_checkpoint(config.checkpoint_path)
        if latest is not None:
            print(f"auto-resume: restarting from {latest}")
            resume_from = str(latest)
    start_step, opt_sd = 0, None
    if resume_from:
        ckpt, start_step, reinit = CheckpointManager.load(resume_from, config, map_location=dev)
        params = ckpt["params"]
        opt_sd = None if reinit else ckpt["opt_state"]
    state, tx = init_train_state(params, config)
    if opt_sd is not None:
        tx.load_state_dict(opt_sd)
    state = TrainState(state.params, state.opt_state, start_step)

    def batches():
        yield from batch_iterator(
            train_ds, batch_size=config.batch_size, semantic_pad_id=token_cfg.pad_id,
            max_len=config.max_sequence_length, duplicate_code_0=model_cfg.duplicate_code_0,
            num_codebooks=model_cfg.num_codebooks, accumulate_steps=config.accumulate_steps,
            seed=config.seed, epochs=config.max_epochs)

    def val_batches():
        it = batch_iterator(
            val_ds, batch_size=config.batch_size, semantic_pad_id=token_cfg.pad_id,
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
                      max_steps=args.max_steps, device=dev)


if __name__ == "__main__":
    main()
