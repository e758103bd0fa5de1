"""A seeded release-format checkpoint directory, written by the benchmark:
`config.json` (the model dict), `tokenizer.json` (the byte-level
vocabulary: 256 byte ids, then the control, speaker and semantic tokens as
added tokens, no merges), `model.safetensors` and `mimi.safetensors` (the
seeded state dicts of portbench/weights.py, in their stored dtype).

safetensors: an 8-byte little-endian header length, a JSON header of
{name: {"dtype", "shape", "data_offsets": [begin, end]}}, then the raw
little-endian bytes."""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict

import torch

_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
          torch.int32: "I32", torch.int64: "I64", torch.int8: "I8"}


def save_safetensors(state: Dict[str, torch.Tensor], path: Path) -> None:
    header, offset, blobs = {}, 0, []
    for name in sorted(state):
        t = state[name].detach().contiguous().cpu()
        data = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)


def tokenizer_json(vocab: dict, codebook_size: int) -> dict:
    specials = (vocab["control_tokens"]
                + [f"<|speaker:{i}|>" for i in range(vocab["speaker_slots"])]
                + [f"<|semantic:{i}|>" for i in range(codebook_size)])
    added = [{"id": 256 + i, "content": s, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, s in enumerate(specials)]
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None, "pre_tokenizer": None, "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": {chr(i): i for i in range(256)}, "merges": []}}


def write(out: Path, config: dict, lm_state: Dict[str, torch.Tensor],
          mimi_state: Dict[str, torch.Tensor]) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(config["model"], indent=1))
    (out / "tokenizer.json").write_text(json.dumps(
        tokenizer_json(config["vocab"], config["model"]["codebook_size"])))
    save_safetensors(lm_state, out / "model.safetensors")
    save_safetensors(mimi_state, out / "mimi.safetensors")
    return out
