"""Data-pipeline prompt encoder (numpy), as the JAX package's
`data_pipeline/prompt.py`: text turns go through the ChatML chat template
(a newline after <|im_end|>), and the VQ encoder carries the experimental
`acoustic_delay` and residual-corruption knobs. Distinct from the
inference-side encoder (`smoltts_torch/lm/prompt.py`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

CHATML_TURN = "<|im_start|>{role}\n{content}<|im_end|>\n"
GENERATION_PROMPT = "<|im_start|>assistant\n"


@dataclasses.dataclass
class TokenizationConfig:
    num_codebooks: int = 8
    acoustic_delay: int = 0
    duplicate_code_0: Optional[bool] = True


class PipelinePromptEncoder:
    def __init__(self, tokenizer, config: TokenizationConfig):
        self.tokenizer = tokenizer
        self.config = config
        self.semantic_offset = self._encode("<|semantic:0|>")[0]
        self.pad_id = self._encode("<|pad|>")[0]
        zeros = [0] * self.depth
        self.trailing_im_end = np.array(
            [self._encode("<|im_end|>") + zeros, self._encode("\n") + zeros],
            dtype=np.int32,
        ).T

    @property
    def depth(self) -> int:
        return (
            self.config.num_codebooks
            if self.config.duplicate_code_0
            else self.config.num_codebooks - 1
        )

    def _encode(self, text: str) -> list:
        return list(self.tokenizer.encode(text))

    def get_lower_zeros(self, length: int) -> np.ndarray:
        return np.zeros((self.depth, length), dtype=np.int32)

    def tokenize_text(self, text: str) -> np.ndarray:
        ids = np.asarray(self._encode(text), dtype=np.int32)[None, :]
        return np.concatenate([ids, self.get_lower_zeros(ids.shape[-1])], axis=0)

    def encode_text_turn(
        self, role: str, content: str, add_generation_prompt: bool = True
    ) -> np.ndarray:
        """ChatML turn via the chat template (trailing newline after im_end)."""
        text = CHATML_TURN.format(role=role, content=content)
        if add_generation_prompt:
            text += GENERATION_PROMPT
        return self.tokenize_text(text)

    def encode_vq(self, codes: np.ndarray) -> np.ndarray:
        """codes [num_codebooks, T] -> VQ block with trailing <|im_end|>\\n.

        With acoustic_delay > 0 the semantic row is padded on the right and
        the codebook rows shifted right (experimental)."""
        if codes.ndim != 2:
            raise ValueError("Must be single batch")
        codes = np.asarray(codes, dtype=np.int32)
        semantic_line = (codes[0, :] + self.semantic_offset)[None, :]
        lower_codes = codes if self.config.duplicate_code_0 else codes[1:, :]

        if self.config.acoustic_delay != 0:
            d = self.config.acoustic_delay
            semantic_line = np.concatenate(
                [semantic_line, np.full((1, d), self.pad_id, np.int32)], axis=1
            )
            lower_codes = np.concatenate(
                [self.get_lower_zeros(d), lower_codes], axis=1
            )

        vq_block = np.concatenate([semantic_line, lower_codes], axis=0)
        return np.concatenate([vq_block, self.trailing_im_end], axis=1)

    def encode_vq_corrupt(
        self, codes: np.ndarray, dropout: float = 0.2, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        """Randomly corrupt non-semantic residual codes (an augmentation
        knob). No temporal delay."""
        if codes.ndim != 2:
            raise ValueError("Must be single batch!")
        rng = rng or np.random.default_rng()
        codes = np.asarray(codes, dtype=np.int32)
        semantic_line = (codes[0, :] + self.semantic_offset)[None, :]
        first_residual = codes[0:1, :]
        remaining = codes[1:, :]
        mask = rng.random(remaining.shape) < dropout
        random_codes = rng.integers(1, 2048, remaining.shape)
        corrupted = np.where(mask, random_codes, remaining).astype(np.int32)
        vq_block = np.concatenate([semantic_line, first_residual, corrupted], axis=0)
        return np.concatenate([vq_block, self.trailing_im_end], axis=1)
