"""Byte-level tokenizer over the smoltts vocabulary, and the resolved
control-token ids the generation loop needs.

Vocabulary layout (the reference's byte-level init script):
  ids 0..255      raw bytes
  ids 256..270    control tokens
  ids 271..319    <|speaker:0..48|>
  ids 320..       <|semantic:0..codebook_size-1|>
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import List, Optional, Union

from smoltts_torch.config import DualARConfig, ModelType

CONTROL_TOKENS = [
    "system",
    "user",
    "assistant",
    "<|british|>",
    "<|american|>",
    "<|male|>",
    "<|female|>",
    "<|unknown|>",
    "<|endoftext|>",
    "<|voice|>",
    "<|semantic|>",
    "<|pad|>",
    "<|epad|>",
    "<|im_start|>",
    "<|im_end|>",
]
CONTROL_BLOCK_SIZE = 64  # control + speaker tokens span ids 256..319


def special_token_list(codebook_size: int = 2048) -> List[str]:
    speakers = [f"<|speaker:{i}|>" for i in range(CONTROL_BLOCK_SIZE - len(CONTROL_TOKENS))]
    semantic = [f"<|semantic:{i}|>" for i in range(codebook_size)]
    return [*CONTROL_TOKENS, *speakers, *semantic]


class ByteTokenizer:
    """Pure-Python byte-level tokenizer: special tokens by leftmost match,
    characters below 256 by codepoint, anything else dropped (the HF
    byte-level vocab has no entry for it). Encodes as HF `tokenizers` does
    on the byte-level `tokenizer.json`: a `<|...|>` span that is not a
    special token is text, and a control word inside it still matches."""

    _SPECIAL_RE = re.compile(r"<\|[^|<>]+\|>|system|user|assistant")

    def __init__(self, codebook_size: int = 2048):
        self.codebook_size = codebook_size
        specials = special_token_list(codebook_size)
        self._special_to_id = {s: 256 + i for i, s in enumerate(specials)}
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        self.vocab_size = 256 + len(specials)

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._special_to_id:
            return self._special_to_id[token]
        if len(token) == 1 and ord(token) < 256:
            return ord(token)
        return None

    def id_to_token(self, idx: int) -> Optional[str]:
        if 0 <= idx < 256:
            return chr(idx)
        return self._id_to_special.get(idx)

    @staticmethod
    def _encode_chars(chunk: str, ids: List[int]) -> None:
        ids.extend(ord(c) for c in chunk if ord(c) < 256)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        while (m := self._SPECIAL_RE.search(text, pos)) is not None:
            tid = self._special_to_id.get(m.group(0))
            if tid is None:  # not special: its "<" is text, search on after it
                self._encode_chars(text[pos : m.start() + 1], ids)
                pos = m.start() + 1
                continue
            self._encode_chars(text[pos : m.start()], ids)
            ids.append(tid)
            pos = m.end()
        self._encode_chars(text[pos:], ids)
        return ids

    def decode(self, ids: List[int]) -> str:
        return "".join(
            chr(i) if 0 <= i < 256 else self._id_to_special.get(i, "") for i in ids
        )


@dataclasses.dataclass(frozen=True)
class TokenConfig:
    """Resolved control-token ids."""

    im_end_id: int
    pad_id: int
    semantic_start_id: int
    semantic_end_id: Optional[int] = None

    @classmethod
    def from_tokenizer(cls, model: ModelType, tokenizer, config: DualARConfig) -> "TokenConfig":
        """`tokenizer` is anything with `.token_to_id`."""
        im_end = tokenizer.token_to_id("<|im_end|>")
        if im_end is None:
            raise ValueError("Tokenizer does not have <|im_end|>")
        modern = model.family == "dual_ar" or (
            model.family == "fish" and model.version == "1.5"
        )
        if modern:
            semantic_start_id = tokenizer.token_to_id("<|semantic:0|>")
            semantic_end_id = tokenizer.token_to_id(
                f"<|semantic:{config.codebook_size - 1}|>"
            )
        else:
            semantic_start_id = tokenizer.token_to_id("<|semantic|>") or 5
            semantic_end_id = None
        pad_id = tokenizer.token_to_id("<|semantic|>") or 5
        return cls(
            im_end_id=im_end,
            pad_id=pad_id,
            semantic_start_id=semantic_start_id,
            semantic_end_id=semantic_end_id,
        )

    @classmethod
    def smoltts_v0(cls, codebook_size: int = 2048) -> "TokenConfig":
        """Static resolution for the canonical byte-level vocab."""
        return cls.from_tokenizer(
            ModelType.smoltts_v0(),
            ByteTokenizer(codebook_size),
            DualARConfig(codebook_size=codebook_size),
        )


def byte_level_tokenizer_json(codebook_size: int = 2048) -> dict:
    """The `tokenizer.json` of the byte-level vocabulary, as HF `tokenizers`
    serializes the reference's init tokenizer: a merge-free BPE over the 256
    latin-1 characters, no normalizer or pre-tokenizer, the special tokens
    as added tokens from id 256."""
    added = [{"id": 256 + i, "content": s, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, s in enumerate(special_token_list(codebook_size))]
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": None,
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": {chr(i): i for i in range(256)}, "merges": []},
    }


def save_byte_level_tokenizer(out_dir: Union[str, Path], codebook_size: int = 2048) -> ByteTokenizer:
    """Write `tokenizer.json` for the byte-level vocabulary (loadable by HF
    `tokenizers`); returns the matching `ByteTokenizer`."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(byte_level_tokenizer_json(codebook_size), f, indent=2, ensure_ascii=False)
    return ByteTokenizer(codebook_size)


def load_tokenizer(checkpoint_dir: Union[str, Path]):
    """The checkpoint's tokenizer: `ByteTokenizer()` when the dir has no
    `tokenizer.json`; for a byte-level `tokenizer.json` (ids 0-255 the
    latin-1 characters, 256.. the special tokens, no merges) the
    `ByteTokenizer` of its codebook size; for any other `tokenizer.json` the
    port's BPE tokenizer (`smoltts_torch.bpe`), which raises
    NotImplementedError for a component it does not read."""
    p = Path(checkpoint_dir) / "tokenizer.json"
    if not p.exists():
        return ByteTokenizer()
    with open(p, "r", encoding="utf-8") as f:
        d = json.load(f)
    model = d.get("model") or {}
    added = d.get("added_tokens") or []
    codebook_size = len(added) - CONTROL_BLOCK_SIZE
    expected = special_token_list(max(codebook_size, 0))
    byte_level = (
        model.get("type") == "BPE"
        and not model.get("merges")
        and model.get("vocab") == {chr(i): i for i in range(256)}
        and d.get("normalizer") is None
        and d.get("pre_tokenizer") is None
        and codebook_size > 0
        and [(t.get("id"), t.get("content")) for t in added]
        == [(256 + i, s) for i, s in enumerate(expected)]
    )
    if byte_level:
        return ByteTokenizer(codebook_size)
    from smoltts_torch.bpe import BPETokenizer

    return BPETokenizer(d)
