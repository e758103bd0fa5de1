"""Train checkpoints: timestamped run dirs `run_{timestamp}` under a base
dir, `step_{N:06d}` checkpoints holding the parameters, the optimizer state
and the step (`state.pt`, torch.save) plus the run's `config.json`,
keep-last-N pruning, restart from the newest step, and `load`'s
`reinit_optimizer` when the AdamW or schedule hyperparameters changed."""

from __future__ import annotations

import json
import shutil
from datetime import datetime
from pathlib import Path
from typing import Optional, Tuple

import torch

from smoltts_torch.config import TrainingConfig
from smoltts_torch.interop import tree_map

OPTIMIZER_KEYS = ["learning_rate", "weight_decay", "betas", "eps"]
SCHEDULER_KEYS = ["lr_start", "lr_warmup_steps"]
STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, base_directory: str, keep_last_n: int = 5, run_name: Optional[str] = None,
                 config: Optional[TrainingConfig] = None):
        self.base_dir = Path(base_directory)
        timestamp = run_name or f"run_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
        self.run_dir = self.base_dir / timestamp
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.keep_last_n = keep_last_n
        self.config = config
        print(f"Checkpoint directory for this run: {self.run_dir}")

    def save(self, state, step: Optional[int] = None,
             config: Optional[TrainingConfig] = None) -> None:
        """Save the TrainState (params, optimizer state, step) and the config."""
        step = int(state.step if step is None else step)
        if step == 0:
            print("Skipping step 0")
            return
        path = self.run_dir / f"step_{step:06d}"
        path.mkdir(parents=True, exist_ok=True)
        ckpt = {
            "params": tree_map(lambda t: t.detach(), state.params),
            "opt_state": state.opt_state.state_dict(),
            "step": step,
        }
        tmp = path / (STATE_FILE + ".tmp")
        torch.save(ckpt, tmp)
        tmp.replace(path / STATE_FILE)
        config = config or self.config
        if config is not None:
            with open(path / "config.json", "w") as f:
                json.dump(config.to_dict(), f, indent=2)
        self._cleanup_old_checkpoints()

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
    def load(checkpoint_path: str, config: TrainingConfig,
             map_location="cpu") -> Tuple[dict, int, bool]:
        """A step dir -> (checkpoint dict, step, reinit_optimizer).
        `reinit_optimizer` is True when the optimizer or schedule
        hyperparameters differ from the checkpoint's recorded config."""
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
