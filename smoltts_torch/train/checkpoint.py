"""Train checkpoints: timestamped run dirs `run_{timestamp}` under a base
dir, `step_{N:06d}` checkpoints holding the parameters, the optimizer state
and the step (`state.pt`, torch.save) plus the run's `config.json`,
keep-last-N pruning, restart from the newest step, and `load`'s
`reinit_optimizer` when the AdamW or schedule hyperparameters changed.

On a mesh (parallel/mesh.py) `save` is collective, as the JAX package's
Orbax save is: every rank takes part in putting the parameters and AdamW's
moments back together (`unshard_params`), and rank 0 alone writes the
whole trees, the config and prunes. A checkpoint so written is the one a
single process writes: `load` returns whole trees, which a rank on a mesh
cuts to its part with `shard_params` and `shard_opt_state`.
"""

from __future__ import annotations

import json
import shutil
from datetime import datetime
from pathlib import Path
from typing import Optional, Tuple

import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import TrainingConfig
from smoltts_torch.interop import tree_map
from smoltts_torch.parallel.mesh import param_partition_specs, shard_by_specs, unshard_params
from smoltts_torch.train.optim import tree_leaves, tree_unflatten

OPTIMIZER_KEYS = ["learning_rate", "weight_decay", "betas", "eps"]
SCHEDULER_KEYS = ["lr_start", "lr_warmup_steps"]
STATE_FILE = "state.pt"


def _moments(opt_sd: dict, params, fn) -> dict:
    """`opt_sd` (AdamW.state_dict of a tree shaped as `params`) with its mu
    and nu, as trees, passed through `fn`."""
    state = {i: dict(st) for i, st in opt_sd["state"].items()}
    n = len(tree_leaves(params))
    for k in ("mu", "nu"):
        tree = fn(tree_unflatten(params, [state[i][k] for i in range(n)]))
        for i, t in enumerate(tree_leaves(tree)):
            state[i][k] = t
    return {**opt_sd, "state": state}


def shard_opt_state(opt_sd: dict, params: dict, mesh, cfg, shard_tables: bool = False) -> dict:
    """A whole tree's AdamW state dict (what `load` returns) cut to this
    rank's part under `param_partition_specs(params, shard_tables)`, for
    `AdamW.load_state_dict` on the rank's leaves."""
    specs = param_partition_specs(params, shard_tables)
    return _moments(opt_sd, params, lambda t: shard_by_specs(t, specs, mesh, cfg))


class CheckpointManager:
    """Run dirs and step checkpoints. On a `mesh` (with the model config
    `model_cfg` and the trees' `shard_tables`), every rank constructs it
    (rank 0 names the run dir) and every rank calls `save`."""

    def __init__(self, base_directory: str, keep_last_n: int = 5, run_name: Optional[str] = None,
                 config: Optional[TrainingConfig] = None, mesh=None, model_cfg=None,
                 shard_tables: bool = False):
        self.base_dir = Path(base_directory)
        self.mesh, self.model_cfg, self.shard_tables = mesh, model_cfg, shard_tables
        timestamp = run_name or f"run_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
        if mesh is not None:
            resolve_device(mesh.device)
            timestamp = mesh.broadcast_object(timestamp)
        self.run_dir = self.base_dir / timestamp
        if self._writes():
            self.run_dir.mkdir(parents=True, exist_ok=True)
            print(f"Checkpoint directory for this run: {self.run_dir}")
        self.keep_last_n = keep_last_n
        self.config = config

    def _writes(self) -> bool:
        return self.mesh is None or (self.mesh.data, self.mesh.model) == (0, 0)

    def save(self, state, step: Optional[int] = None,
             config: Optional[TrainingConfig] = None) -> None:
        """Save the TrainState (params, optimizer state, step) and the config;
        on a mesh the whole trees, from every rank's part."""
        if self.mesh is not None:
            resolve_device(self.mesh.device)
        step = int(state.step if step is None else step)
        if step == 0:
            print("Skipping step 0")
            return
        params = tree_map(lambda t: t.detach(), state.params)
        opt_sd = state.opt_state.state_dict()
        if self.mesh is not None:
            whole = lambda t: unshard_params(t, self.mesh, self.model_cfg, self.shard_tables)
            opt_sd = _moments(opt_sd, params, whole)
            params = whole(params)
        if self._writes():
            path = self.run_dir / f"step_{step:06d}"
            path.mkdir(parents=True, exist_ok=True)
            tmp = path / (STATE_FILE + ".tmp")
            torch.save({"params": params, "opt_state": opt_sd, "step": step}, tmp)
            tmp.replace(path / STATE_FILE)
            config = config or self.config
            if config is not None:
                with open(path / "config.json", "w") as f:
                    json.dump(config.to_dict(), f, indent=2)
            self._cleanup_old_checkpoints()
        if self.mesh is not None:  # every rank returns once the step is on disk
            self.mesh.broadcast_object(None)

    def _cleanup_old_checkpoints(self):
        dirs = sorted(self.run_dir.glob("step_*"))
        for d in dirs[: max(0, len(dirs) - self.keep_last_n)]:
            shutil.rmtree(d)

    @staticmethod
    def latest_step_dir(run_dir: Path) -> Optional[Path]:
        dirs = sorted(Path(run_dir).glob("step_*"))
        return dirs[-1] if dirs else None

    @staticmethod
    def latest_checkpoint(base_directory: str) -> Optional[Path]:
        """The newest step checkpoint across all runs under `base_directory`:
        newest step first, the run dir's name as the tiebreaker."""
        best: Optional[Path] = None
        for step_dir in Path(base_directory).glob("*/step_*"):
            if best is None or (step_dir.name, step_dir.parent.name) > (
                best.name, best.parent.name
            ):
                best = step_dir
        return best

    @staticmethod
    def load(checkpoint_path: str, config: TrainingConfig, map_location="cpu",
             mesh=None) -> Tuple[dict, int, bool]:
        """A step dir -> (checkpoint dict, step, reinit_optimizer).
        `reinit_optimizer` is True when the optimizer or schedule
        hyperparameters differ from the checkpoint's recorded config. The
        trees are whole, on `mesh.device` (None meaning CUDA) for a rank of a
        mesh; shard them with `shard_params` and `shard_opt_state`."""
        if mesh is not None:
            map_location = resolve_device(mesh.device)
        path = Path(checkpoint_path)
        ckpt = torch.load(path / STATE_FILE, map_location=map_location, weights_only=True)
        step = int(ckpt["step"])
        reinit = False
        cfg_path = path / "config.json"
        if cfg_path.exists():
            with open(cfg_path) as f:
                old = TrainingConfig.from_dict(json.load(f))
            changed = [k for k in OPTIMIZER_KEYS + SCHEDULER_KEYS
                       if getattr(config, k) != getattr(old, k)]
            if changed:
                print("Detected changes in optimization parameters:")
                for k in changed:
                    print(f"  {k}: {getattr(old, k)} -> {getattr(config, k)}")
                print("Will reinitialize optimizer with new settings")
                reinit = True
        return ckpt, step, reinit
