"""ChatML turn assembly for DualAR decoding.

Every turn is a ``[1 + depth, T]`` int32 matrix: the top row carries text
ids, the remaining ``depth`` rows carry Mimi codebook ids (zero on text
columns). Audio turns shift codebook 0 into the ``<|semantic:n|>`` range and
close with an ``<|im_end|>\\n`` block.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from smoltts_torch.config import DualARConfig, ModelType

CHATML_OPEN = "<|im_start|>"
CHATML_CLOSE = "<|im_end|>"


def _token_ids(tokenizer, text: str) -> list:
    enc = tokenizer.encode(text)
    return list(enc) if isinstance(enc, list) else list(enc.ids)


def text_rows(tokenizer, text: str, depth: int) -> np.ndarray:
    """Tokenize `text` into the top row of a [1+depth, T] turn matrix."""
    ids = _token_ids(tokenizer, text)
    rows = np.zeros((1 + depth, len(ids)), dtype=np.int32)
    rows[0] = ids
    return rows


def audio_rows(codes: np.ndarray, depth: int, semantic_offset: int) -> np.ndarray:
    """Mimi codes [num_codebooks, T] -> [1+depth, T] turn body."""
    codes = np.asarray(codes)
    if codes.ndim != 2:
        raise ValueError(f"expected [num_codebooks, T] codes, got shape {codes.shape}")
    body = np.empty((1 + depth, codes.shape[1]), dtype=np.int32)
    body[0] = codes[0] + semantic_offset
    body[1:] = codes[codes.shape[0] - depth :]
    return body


class PromptEncoder:
    """Bundles a tokenizer with the model constants the turn format needs."""

    def __init__(
        self,
        tokenizer,
        model_type: ModelType,
        semantic_offset: int,
        num_codebooks: int = 8,
        duplicate_code_0: bool = True,
    ):
        self.tokenizer = tokenizer
        self.model_type = model_type
        self.semantic_offset = semantic_offset
        self.depth = num_codebooks if duplicate_code_0 else num_codebooks - 1

    @classmethod
    def from_config(cls, tokenizer, cfg: DualARConfig, token_cfg, model_type=None):
        return cls(
            tokenizer,
            model_type=model_type or ModelType.smoltts_v0(),
            semantic_offset=token_cfg.semantic_start_id,
            num_codebooks=cfg.num_codebooks,
            duplicate_code_0=cfg.duplicate_code_0,
        )

    def encode_text_turn(self, role: str, content: Optional[str] = None) -> np.ndarray:
        """`<|im_start|>role\\n` opener; closed with content + `<|im_end|>`
        when content is given, left open (generation prefix) otherwise."""
        body = "" if content is None else f"{content}{CHATML_CLOSE}"
        return text_rows(self.tokenizer, f"{CHATML_OPEN}{role}\n{body}", self.depth)

    def encode_vq(self, codes: np.ndarray) -> np.ndarray:
        """Audio turn: code rows followed by `<|im_end|>\\n` closing columns."""
        turn = audio_rows(codes, self.depth, self.semantic_offset)
        closer = text_rows(self.tokenizer, f"{CHATML_CLOSE}\n", self.depth)
        return np.concatenate([turn, closer], axis=1)
