"""Dataset tokenizer: Mimi-code utterances -> packed ChatML training rows.

As the JAX package's `data_pipeline/tokenize_dataset.py`: a JSON config
chooses the tokenization strategy, the speaker strategy (`id_token` with a
speaker list -> `<|speaker:n|>` system turns, a `fixed` sysprompt, or
`omit`), the longest utterance kept, and first-fit-decreasing packing per
speaker within `max_sequence_length` (the system turn's width reserved up
front). Rows come out as `ground_truth [1 + depth, T]`; the causal shift
stays at train-time collation (`smoltts_torch/train/data.py`).

The config is dataclasses parsed by `PipelineConfig.from_dict`, which
accepts and rejects what the JAX package's pydantic models do: required
sections and fields, the strategy literals, pydantic's lax coercions of
numbers, booleans and strings; unknown keys are ignored.

    python -m smoltts_torch.data_pipeline.tokenize_dataset -c cfg.json -o out_dir
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Literal, Optional

import numpy as np

from smoltts_torch.data_pipeline.prompt import PipelinePromptEncoder, TokenizationConfig

NUM_PROC = 12

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _coerce(tp, v, where: str):
    """`v` as pydantic (v2, lax mode) validates it against `tp`."""
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin is typing.Union:  # Optional[X]
        if v is None:
            return None
        return _coerce(next(a for a in args if a is not type(None)), v, where)
    if origin is Literal:
        if isinstance(v, str) and v in args:
            return v
        raise ValueError(f"{where}: input should be one of {list(args)}, got {v!r}")
    if origin in (list, List):
        if not isinstance(v, (list, tuple)):
            raise ValueError(f"{where}: input should be a valid list, got {v!r}")
        return [_coerce(args[0], x, f"{where}.{i}") for i, x in enumerate(v)]
    if dataclasses.is_dataclass(tp):
        if not isinstance(v, dict):
            raise ValueError(f"{where}: input should be an object, got {v!r}")
        return _parse(tp, v, where)
    if tp is str:
        if isinstance(v, str):
            return v
    elif tp is bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        if isinstance(v, str) and v.strip().lower() in _TRUE | _FALSE:
            return v.strip().lower() in _TRUE
    elif tp is int:
        if isinstance(v, (bool, int)):
            return int(v)
        if isinstance(v, float) and v.is_integer():
            return int(v)
        if isinstance(v, str):
            try:
                return int(v.strip())
            except ValueError:
                try:
                    f = float(v.strip())
                except ValueError:
                    f = None
                if f is not None and f.is_integer():
                    return int(f)
    elif tp is float:
        if isinstance(v, (bool, int, float)):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v.strip())
            except ValueError:
                pass
    raise ValueError(f"{where}: input should be a valid {getattr(tp, '__name__', tp)}, "
                     f"got {v!r}")


def _parse(cls, d: dict, where: str):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        path = f"{where}.{f.name}" if where else f.name
        if f.name in d:
            kw[f.name] = _coerce(hints[f.name], d[f.name], path)
        elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
            raise ValueError(f"{path}: field required")
    return cls(**kw)


@dataclasses.dataclass
class TokenizationStrategy:
    tokenizer_path: str
    strategy: Literal["bpe", "bytelevel", "phoneme", "hybrid"]
    duplicate_code_0: Optional[bool] = True


@dataclasses.dataclass
class AudioConfig:
    frame_rate: float = 12.5
    max_sample_secs: float = 15.0


@dataclasses.dataclass
class SpeakerStrategy:
    strategy: Literal["id_token", "fixed", "omit"]
    speaker_names: Optional[List[str]] = None
    default_sysprompt: Optional[str] = None


@dataclasses.dataclass
class PackingStrategy:
    max_sequence_length: int = 768
    max_items_per_pack: int = 5  # read and unused, as in the JAX package
    window_size: int = 1600


@dataclasses.dataclass
class PipelineConfig:
    tokenization: TokenizationStrategy
    speaker: SpeakerStrategy
    audio: AudioConfig
    dataset_id: Optional[str] = None
    dataset_path: Optional[str] = None
    packing: Optional[PackingStrategy] = None

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        if not isinstance(d, dict):
            raise ValueError(f"pipeline config: input should be an object, got {d!r}")
        return _parse(cls, d, "")

    @classmethod
    def from_json(cls, path) -> "PipelineConfig":
        return cls.from_dict(json.loads(Path(path).read_text(encoding="utf-8")))


class SyspromptEncoder:
    """Caches the per-speaker (or fixed) system turn and prepends it."""

    def __init__(self, dataset_config: PipelineConfig, prompt_encoder: PipelinePromptEncoder):
        self.dataset_config = dataset_config

        def system_turn(content: str) -> np.ndarray:
            return prompt_encoder.encode_text_turn(
                role="system", content=content, add_generation_prompt=False
            )

        spk = dataset_config.speaker
        self.default_sysprompt: Optional[np.ndarray] = (
            system_turn(spk.default_sysprompt) if spk.default_sysprompt is not None else None
        )
        self.speaker_cache: Optional[Dict[str, np.ndarray]] = None
        if self.default_sysprompt is None and spk.speaker_names is not None:
            self.speaker_cache = {
                name: system_turn(f"<|speaker:{i}|>")
                for i, name in enumerate(spk.speaker_names)
            }

    def _turn_for(self, speaker_id: str) -> Optional[np.ndarray]:
        if self.default_sysprompt is not None:
            return self.default_sysprompt
        if self.speaker_cache is not None:
            return self.speaker_cache[speaker_id]
        return None

    def get_sysprompt_length(self, speaker_id: str) -> int:
        turn = self._turn_for(speaker_id)
        return 0 if turn is None else turn.shape[-1]

    def add_sysprompt(self, ground_truth: np.ndarray, speaker_id: str) -> np.ndarray:
        if self.dataset_config.speaker.strategy == "omit":
            return ground_truth
        turn = self._turn_for(speaker_id)
        if turn is None:
            raise ValueError(
                f"speaker strategy {self.dataset_config.speaker.strategy!r} requires "
                "default_sysprompt or speaker_names"
            )
        return np.concatenate([turn, ground_truth], axis=1)


def tts_tokenize_row(
    row: Dict, prompt_encoder: PipelinePromptEncoder, dataset_config: PipelineConfig
) -> Dict:
    """One utterance -> [user ChatML turn | VQ assistant turn] columns."""
    text = row["text_normalized"]
    if dataset_config.tokenization.strategy == "bpe":
        text = text.encode("utf-8").decode("latin-1")
    turns = [
        prompt_encoder.encode_text_turn(role="user", content=text, add_generation_prompt=True),
        prompt_encoder.encode_vq(np.asarray(row["codes"])),
    ]
    return {"ground_truth": np.concatenate(turns, axis=1)}


def causal_shift_row(row: Dict) -> Dict:
    gt = np.asarray(row["ground_truth"])
    tokens, labels = gt[:, :-1].copy(), gt[:, 1:].copy()
    labels[1:][labels[1:] == 0] = -100  # text-only columns carry no codebook loss
    return {"tokens": tokens, "labels": labels}


def pack_utterances(batch: Dict, sysprompt_encoder: SyspromptEncoder) -> Dict:
    """First-fit-decreasing packing, grouped by speaker.

    Each speaker gets a column budget of max_sequence_length minus its system
    turn width; bins hold utterance lists and are concatenated (and prefixed
    with the system turn) only once, at emission.
    """
    max_len = sysprompt_encoder.dataset_config.packing.max_sequence_length

    by_speaker: Dict[str, list] = defaultdict(list)
    for sid, gt in zip(batch["speaker_id"], batch["ground_truth"]):
        by_speaker[sid].append(np.asarray(gt))

    out_rows, out_ids = [], []
    for sid, utts in by_speaker.items():
        budget = max_len - sysprompt_encoder.get_sysprompt_length(sid)
        bins: list = []  # [used_columns, [utterance, ...]]
        for utt in sorted(utts, key=lambda u: u.shape[-1], reverse=True):
            width = utt.shape[-1]
            for slot in bins:
                if slot[0] + width <= budget:
                    slot[0] += width
                    slot[1].append(utt)
                    break
            else:
                bins.append([width, [utt]])
        for _, members in bins:
            seq = members[0] if len(members) == 1 else np.concatenate(members, axis=1)
            out_rows.append(sysprompt_encoder.add_sysprompt(seq, sid))
            out_ids.append(sid)
    return {"ground_truth": out_rows, "speaker_id": out_ids}


def process_rows(rows: List[Dict], cfg: PipelineConfig, prompt_encoder: PipelinePromptEncoder,
                 sysprompt_encoder: SyspromptEncoder) -> List[Dict]:
    """`main`'s work on a list of rows in one process: drop utterances
    longer than `max_sample_secs`, tokenize, and pack each window of
    `window_size` rows. Equal to `main` in one process and one shard."""
    frame_cap = cfg.audio.frame_rate * cfg.audio.max_sample_secs
    kept = [r for r in rows if np.asarray(r["codes"]).shape[-1] <= frame_cap]
    out = []
    for r in kept:
        row = {k: v for k, v in r.items() if k != "codes"}
        row.update(tts_tokenize_row(r, prompt_encoder, cfg))
        out.append(row)
    if cfg.packing is None:
        return out
    packed = []
    w = cfg.packing.window_size
    for start in range(0, len(out), w):
        window = out[start : start + w]
        batch = pack_utterances({"speaker_id": [r["speaker_id"] for r in window],
                                 "ground_truth": [r["ground_truth"] for r in window]},
                                sysprompt_encoder)
        packed.extend({"ground_truth": gt, "speaker_id": sid}
                      for gt, sid in zip(batch["ground_truth"], batch["speaker_id"]))
    return packed


def _load_tokenizer(path: str):
    """The port's tokenizer of a `tokenizer.json` (a file or a dir holding
    one): `ByteTokenizer` for the byte-level vocabulary, the BPE tokenizer
    for any other; `ByteTokenizer()` when there is none."""
    from smoltts_torch.tokenizer import ByteTokenizer, load_tokenizer

    p = Path(path)
    tok_file = p / "tokenizer.json" if p.is_dir() else p
    if tok_file.suffix == ".json" and tok_file.exists():
        if tok_file.name == "tokenizer.json":
            return load_tokenizer(tok_file.parent)
        from smoltts_torch.bpe import BPETokenizer

        return BPETokenizer.from_file(tok_file)
    return ByteTokenizer()


def _open_dataset(cfg: PipelineConfig):
    from datasets import load_dataset, load_from_disk

    if cfg.dataset_path:
        ds = load_from_disk(cfg.dataset_path)
    elif cfg.dataset_id:
        ds = load_dataset(cfg.dataset_id)
    else:
        raise ValueError("Neither dataset_id nor dataset_path specified in config!")
    # normalize column names the encoders expect
    cols = ds["train"].column_names
    if "text" in cols:
        ds = ds.rename_column("text", "text_normalized")
    if "speaker" in cols:
        ds = ds.rename_column("speaker", "speaker_id")
    return ds


def _process_shard(shard, cfg, prompt_encoder, sysprompt_encoder, num_proc: int):
    frame_cap = cfg.audio.frame_rate * cfg.audio.max_sample_secs
    print(f"Filtering rows above {cfg.audio.max_sample_secs}s")
    shard = shard.filter(
        lambda row: np.asarray(row["codes"]).shape[-1] <= frame_cap, num_proc=num_proc
    )
    print("Tokenizing dataset")
    shard = shard.map(
        lambda row: tts_tokenize_row(row, prompt_encoder, cfg),
        remove_columns="codes",
        num_proc=num_proc,
    )
    if cfg.packing is not None:
        print("Packing sequence")
        shard = shard.map(
            lambda rows: pack_utterances(rows, sysprompt_encoder),
            batched=True,
            batch_size=cfg.packing.window_size,
            num_proc=num_proc,
            remove_columns=shard.column_names,
        )
    return shard


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Tokenize Mimi-encoded dataset for final consumption"
    )
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-o", "--out-path", type=str, required=True)
    parser.add_argument("--shards", type=int)
    parser.add_argument("--num-proc", type=int, default=NUM_PROC)
    args = parser.parse_args(argv)

    cfg = PipelineConfig.from_json(args.config)
    dataset = _open_dataset(cfg)
    print("Loaded dataset")

    prompt_encoder = PipelinePromptEncoder(
        _load_tokenizer(cfg.tokenization.tokenizer_path),
        TokenizationConfig(duplicate_code_0=cfg.tokenization.duplicate_code_0),
    )
    sysprompt_encoder = SyspromptEncoder(cfg, prompt_encoder)

    from datasets import DatasetDict, concatenate_datasets

    n_shards = args.shards or 1
    done = [
        _process_shard(
            dataset["train"].shard(n_shards, i), cfg, prompt_encoder,
            sysprompt_encoder, args.num_proc,
        )
        for i in range(n_shards)
    ]
    DatasetDict({"train": concatenate_datasets(done)}).save_to_disk(
        args.out_path, max_shard_size="5GB"
    )


if __name__ == "__main__":
    main()
