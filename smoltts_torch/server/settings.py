"""Server settings as plain dataclasses (the JAX package's pydantic models in
`smoltts_tpu/server/settings.py`; the card's machine has no pydantic).

model_id XOR checkpoint_dir; a default config file is bootstrapped into the
user cache dir on first run. A hub download is attempted only when a model_id
is configured and `huggingface_hub` is importable; checkpoint_dir is the
primary path. Unknown keys are ignored, as pydantic's models ignore them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

from smoltts_torch.config import ModelType
from smoltts_torch.lm.samplers import GenerationSettings


def _known(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _opt_float(x) -> Optional[float]:
    return None if x is None else float(x)


@dataclasses.dataclass
class GenerationSettingsModel:
    default_temp: float = 0.5
    default_fast_temp: Optional[float] = 0.0
    min_p: Optional[float] = 0.10
    max_new_tokens: int = 1024

    def __post_init__(self):
        self.default_temp = float(self.default_temp)
        self.default_fast_temp = _opt_float(self.default_fast_temp)
        self.min_p = _opt_float(self.min_p)
        self.max_new_tokens = int(self.max_new_tokens)

    @classmethod
    def from_dict(cls, d: dict) -> "GenerationSettingsModel":
        return cls(**_known(cls, d))

    def to_settings(self) -> GenerationSettings:
        return GenerationSettings(
            default_temp=self.default_temp,
            default_fast_temp=self.default_fast_temp,
            min_p=self.min_p,
            max_new_tokens=self.max_new_tokens,
        )


DEFAULT_SETTINGS = {
    "model_id": "jkeisling/smoltts_v0",
    "model_type": {"family": "dual_ar", "codec": "mimi", "version": None},
    "generation": {
        "default_temp": 0.5,
        "default_fast_temp": 0.0,
        "min_p": 0.10,
        "max_new_tokens": 1024,
    },
}


def _cache_config_path() -> Path:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return Path(base) / "smoltts" / "settings" / "config.json"


@dataclasses.dataclass
class ServerSettings:
    model_id: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    mimi_path: Optional[str] = None
    generation: GenerationSettingsModel = dataclasses.field(
        default_factory=GenerationSettingsModel)
    model_type: ModelType = dataclasses.field(default_factory=ModelType.smoltts_v0)

    def __post_init__(self):
        if isinstance(self.generation, dict):
            self.generation = GenerationSettingsModel.from_dict(self.generation)
        if isinstance(self.model_type, dict):
            self.model_type = ModelType(**_known(ModelType, self.model_type))
        if self.model_id is not None and self.checkpoint_dir is not None:
            raise ValueError("Cannot specify both model_id and checkpoint_dir")
        if self.model_id is None and self.checkpoint_dir is None:
            raise ValueError("Must specify either model_id or checkpoint_dir")

    @classmethod
    def from_dict(cls, d: dict) -> "ServerSettings":
        return cls(**_known(cls, d))

    @classmethod
    def get_settings(cls, config_path: Optional[str] = None) -> "ServerSettings":
        if config_path:
            with open(config_path) as f:
                return cls.from_dict(json.load(f))
        path = _cache_config_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        if not path.exists():
            with open(path, "w") as f:
                json.dump(DEFAULT_SETTINGS, f, indent=2)
            return cls.from_dict(DEFAULT_SETTINGS)
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def get_checkpoint_dir(self) -> Path:
        if self.checkpoint_dir is not None:
            return Path(self.checkpoint_dir)
        try:
            from huggingface_hub import snapshot_download  # type: ignore

            return Path(snapshot_download(self.model_id))
        except Exception as e:  # no hub / no network
            raise RuntimeError(
                f"cannot download {self.model_id!r} (no hub access): {e}; "
                "set checkpoint_dir in the server config"
            )
