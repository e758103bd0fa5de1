"""DualAR model configuration as plain dataclasses.

Field names mirror the reference `config.json` schema, so a released
checkpoint's config loads without translation. The derived fields are filled
in `__post_init__` exactly as `smoltts_tpu.config.DualARConfig._fill_defaults`
fills them.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple, Union


@dataclasses.dataclass
class ModelType:
    """Model family registry."""

    family: str  # "dual_ar" | "fish"
    version: Optional[str] = None
    codec: str = "mimi"

    @classmethod
    def smoltts_v0(cls) -> "ModelType":
        return cls(family="dual_ar", version=None, codec="mimi")


@dataclasses.dataclass
class DualARConfig:
    """DualAR / RQ-Transformer hyperparameters. Unknown keys are ignored by
    `from_dict`, so legacy configs load."""

    model_type: str = "dual_ar"

    # Slow (backbone) transformer
    vocab_size: int = 2368
    n_layer: int = 10
    n_head: int = 12
    n_local_heads: int = -1  # GQA KV heads; -1 means == n_head
    head_dim: int = 64
    dim: int = 768
    intermediate_size: int = 3072
    rope_base: float = 10_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dropout: float = 0.0
    tie_word_embeddings: bool = True
    attention_qkv_bias: bool = False
    initializer_range: float = 0.02

    # Codebooks
    codebook_size: int = 2048
    num_codebooks: int = 8

    # Fast (depth) transformer
    fast_dim: Optional[int] = None
    n_fast_layer: int = 4
    fast_n_head: Optional[int] = None
    fast_n_local_heads: Optional[int] = None
    fast_head_dim: Optional[int] = None
    fast_intermediate_size: Optional[int] = None
    fast_attention_qkv_bias: Optional[bool] = None
    depthwise_wte: bool = False
    depthwise_output: bool = False
    duplicate_code_0: bool = True

    use_gradient_checkpointing: bool = False

    def __post_init__(self):
        if self.n_local_heads == -1:
            self.n_local_heads = self.n_head
        self.head_dim = self.dim // self.n_head
        if self.fast_dim is None:
            self.fast_dim = self.dim
        if self.fast_n_head is None:
            self.fast_n_head = self.n_head
        if self.fast_n_local_heads is None:
            self.fast_n_local_heads = self.n_local_heads
        self.fast_head_dim = self.fast_dim // self.fast_n_head
        if self.fast_intermediate_size is None:
            self.fast_intermediate_size = self.intermediate_size
        if self.fast_attention_qkv_bias is None:
            self.fast_attention_qkv_bias = self.attention_qkv_bias

    @property
    def num_rows(self) -> int:
        """Rows per time step: 1 text row + codebook rows (the semantic code
        rides both row 0 and row 1 under duplicate_code_0)."""
        return 1 + self.num_codebooks - (0 if self.duplicate_code_0 else 1)

    @property
    def max_fast_seqlen(self) -> int:
        """Number of codes the fast transformer predicts per frame."""
        return self.num_codebooks - (0 if self.duplicate_code_0 else 1)

    @property
    def fast_embedding_rows(self) -> int:
        if self.depthwise_wte:
            return self.codebook_size * (self.num_codebooks - 1)
        return self.codebook_size

    def replace(self, **overrides) -> "DualARConfig":
        return dataclasses.replace(self, **overrides)

    @classmethod
    def from_dict(cls, d: dict) -> "DualARConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json_file(cls, path: Union[str, Path]) -> "DualARConfig":
        p = Path(path)
        if p.is_dir():
            p = p / "config.json"
        with open(p, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: Union[str, Path]) -> None:
        """Write `config.json` as the JAX package writes it (sorted keys,
        4-space indent)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=4, sort_keys=True, ensure_ascii=False)


def smoltts_byte_150m() -> DualARConfig:
    """The released 150M config (sample_model_sizes/smoltts_byte_150m.json)."""
    return DualARConfig(
        vocab_size=2368,
        n_layer=10,
        n_head=12,
        n_local_heads=4,
        dim=768,
        intermediate_size=3072,
        rope_base=100_000,
        dropout=0.1,
        codebook_size=2048,
        num_codebooks=8,
        fast_dim=768,
        n_fast_layer=4,
        fast_n_head=12,
        fast_n_local_heads=4,
        fast_intermediate_size=3072,
        depthwise_wte=True,
        depthwise_output=True,
        duplicate_code_0=True,
        tie_word_embeddings=True,
        use_gradient_checkpointing=True,
        initializer_range=0.041666666666666664,
    )


def smoltts_byte_70m() -> DualARConfig:
    """The released 70M config (sample_model_sizes/smoltts_byte_70m.json)."""
    return smoltts_byte_150m().replace(
        dim=576,
        n_head=9,
        n_local_heads=3,
        intermediate_size=1536,
        fast_dim=576,
        fast_n_head=9,
        fast_n_local_heads=3,
        fast_intermediate_size=1536,
    )


def tiny_debug_config(**overrides) -> DualARConfig:
    """A tiny config for tests: full feature surface, minute dims."""
    base = dict(
        vocab_size=2368,
        n_layer=2,
        n_head=2,
        n_local_heads=1,
        dim=64,
        intermediate_size=128,
        rope_base=100_000,
        codebook_size=2048,
        num_codebooks=8,
        fast_dim=64,
        n_fast_layer=2,
        fast_n_head=2,
        fast_n_local_heads=1,
        fast_intermediate_size=128,
        depthwise_wte=True,
        depthwise_output=True,
        duplicate_code_0=True,
        max_seq_len=128,
        dropout=0.0,
    )
    base.update(overrides)
    return DualARConfig(**base)


@dataclasses.dataclass
class TrainingConfig:
    """Training-run config: the reference's keys plus the JAX package's extras,
    with its defaults. Unknown keys are ignored (`from_dict`), so every JSON
    under `config/` loads. `mesh_data_axis` x `mesh_model_axis` is the mesh
    of a multi-process run (train/main.py); one process with no process
    group trains on a 1 x 1 mesh."""

    # Core paths and identifiers
    project_name: str = "smoltts_train"
    checkpoint_path: str = "checkpoints"
    model_path: str = "pretrained_model"
    dataset_path: str = ""
    init_folder: str = ""

    # Training params
    batch_size: int = 8
    max_epochs: int = 10
    num_workers: int = 4
    gradient_clip: float = 1.0
    accumulate_steps: int = 1

    # Optimizer
    learning_rate: float = 1e-4
    lr_start: float = 1e-3
    lr_warmup_steps: int = 3000
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-5

    # Validation & checkpointing
    val_every_n_steps: int = 100
    save_every_n_steps: int = 500
    keep_last_n_checkpoints: int = 5

    # Model/data params
    max_sequence_length: int = 896
    use_bf16: bool = True
    use_wandb: bool = False
    use_pretrained: bool = True

    # Extras of the JAX package
    mesh_data_axis: int = -1
    mesh_model_axis: int = 1
    sequence_parallel: bool = False
    auto_resume: bool = False  # resume from the newest checkpoint under checkpoint_path
    seed: int = 0
    log_every_n_steps: int = 10
    remat_policy: str = "none"  # "none" | "dots" (models/dual_ar.py::run_trunk)
    # >0: the fast trunk and codebook CE fused and chunked over time
    # (train/loss.py::forward_train_loss); must divide the sequence length.
    fast_chunk_t: int = 0
    # >0: a torch.profiler trace over steps [2, 2 + profile_steps)
    profile_steps: int = 0
    profile_dir: str = "smoltts_trace"

    def __post_init__(self):
        # JSON has no tuples: a loaded config must compare equal to a built one
        self.betas = tuple(float(b) for b in self.betas)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_training_config(path: Union[str, Path]) -> TrainingConfig:
    with open(path, "r", encoding="utf-8") as f:
        return TrainingConfig.from_dict(json.load(f))
