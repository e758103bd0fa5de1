"""The library's public entry point: `SmolTTS` loads a release-format DualAR
checkpoint plus the Mimi codec, synthesizes PCM with `__call__`, streams
80 ms chunks with `stream()`, and builds voice-cloning prompts with
`create_speaker()`, with the JAX package's behaviour.

On the card every frame runs the three kernels: the slow trunk's decode
attention, the slow-token sampler and, for int8 trees, the fast loop.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig, ModelType
from smoltts_torch.tokenizer import TokenConfig, load_tokenizer
from smoltts_torch.utils.profiling import SPANS

# The reference's Kokoro voice registry.
VOICES = [
    "heart",
    "bella",
    "nova",
    "sky",
    "sarah",
    "michael",
    "fenrir",
    "liam",
    "emma",
    "isabella",
    "fable",
]


def _pcm_numpy(pcm: torch.Tensor) -> np.ndarray:
    return pcm.float().cpu().numpy().flatten()


def _pcm_to_host(pcm: torch.Tensor) -> np.ndarray:
    """A streamed chunk on the host: where the library waits for the card
    (span `stream.to_host`)."""
    with SPANS.span("stream.to_host"):
        return _pcm_numpy(pcm)


class SmolTTS:
    """End-to-end text-to-speech over a DualAR LM and the Mimi vocoder."""

    def __init__(self, checkpoint_dir: Union[str, Path],
                 mimi_path: Optional[Union[str, Path]] = None, dtype=None,
                 generation_settings=None, quantize: Optional[str] = None, device=None,
                 seed: int = 0):
        """`quantize="int8"` stores the LM trunks and heads as int8 weights
        (the fast loop then runs as one kernel); `"int8+kv8"` also keeps the
        streaming KV history and codec ring in int8 with per-vector scales.
        `device=None` means CUDA; `seed` seeds the sampling generator, which
        advances across calls."""
        from smoltts_torch.codec.config import MimiConfig
        from smoltts_torch.codec.graph import VocoderGraphs
        from smoltts_torch.codec.mimi import load_mimi
        from smoltts_torch.io.checkpoint import load_params
        from smoltts_torch.lm.graph import LMFrameGraphs
        from smoltts_torch.lm.prompt import PromptEncoder
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.ops.quant import (
            fuse_decode_params,
            fuse_mimi_decode_params,
            quantize_decode_params,
        )

        if quantize not in (None, "int8", "int8+kv8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (use 'int8' or 'int8+kv8')")
        self.device = resolve_device(device)
        self.kv_dtype = torch.int8 if quantize == "int8+kv8" else torch.bfloat16

        checkpoint_dir = Path(checkpoint_dir)
        self.config = DualARConfig.from_json_file(checkpoint_dir / "config.json")
        self.tokenizer = load_tokenizer(checkpoint_dir)
        self.model_type = ModelType.smoltts_v0()
        self.token_config = TokenConfig.from_tokenizer(self.model_type, self.tokenizer, self.config)
        self.params = fuse_decode_params(
            load_params(checkpoint_dir, self.config, dtype=dtype, device=self.device))
        if quantize is not None:
            self.params = quantize_decode_params(self.params)
        self.prompt_encoder = PromptEncoder.from_config(self.tokenizer, self.config,
                                                        self.token_config, self.model_type)
        self.generation_settings = generation_settings or GenerationSettings()

        self.codec_params = None
        self.codec_config = MimiConfig()
        if mimi_path is None:
            candidate = checkpoint_dir / "mimi.safetensors"
            mimi_path = candidate if candidate.exists() else None
        if mimi_path is not None:
            params, self.codec_config = load_mimi(mimi_path, dtype=dtype, device=self.device)
            self.codec_params = fuse_mimi_decode_params(params)

        self.sampling_rate = self.codec_config.sampling_rate
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # stream()'s B=1 vocoder and LM states, reset in place for each
        # stream and replayed as CUDA graphs; a stream() that finds them
        # taken by another open stream steps states of its own eagerly.
        self._vocoder = VocoderGraphs(max_graphs=1)
        self._lm_frame = LMFrameGraphs(max_graphs=1)
        self._stream_mimi = None  # made at the first stream()
        self._stream_lm = None
        self._stream_states_lock = threading.Lock()
        self._stream_states_taken = False

        # voices.json maps names to speaker ids; speakers/<name>.npy holds
        # saved conditioning prompts (save_speaker / create_speaker).
        self.voices = list(VOICES)
        self._speaker_dir = checkpoint_dir / "speakers"
        self._speaker_cache: dict = {}
        voices_path = checkpoint_dir / "voices.json"
        if voices_path.exists():
            with open(voices_path) as f:
                self.voices = json.load(f)

    def get_speaker(self, name: str) -> Optional[np.ndarray]:
        """Saved conditioning prompt for a cloned voice, if any."""
        if name in self._speaker_cache:
            return self._speaker_cache[name]
        path = self._speaker_dir / f"{name}.npy"
        if path.exists():
            prompt = np.load(path)
            self._speaker_cache[name] = prompt
            return prompt
        return None

    def save_speaker(self, name: str, prompt: np.ndarray) -> None:
        """Persist a create_speaker() conditioning prompt under the checkpoint."""
        self._speaker_dir.mkdir(parents=True, exist_ok=True)
        np.save(self._speaker_dir / f"{name}.npy", np.asarray(prompt, np.int32))
        self._speaker_cache[name] = np.asarray(prompt, np.int32)

    def _get_prompt(self, text: str, voice: str, sysprompt: Optional[np.ndarray] = None) -> np.ndarray:
        if sysprompt is None:
            sysprompt = self.get_speaker(voice)
        if sysprompt is None:
            voice_id = self.voices.index(voice) if voice in self.voices else 0
            sysprompt = self.prompt_encoder.encode_text_turn("system", f"<|speaker:{voice_id}|>")
        user = self.prompt_encoder.encode_text_turn("user", text)
        assistant_prefix = self.prompt_encoder.encode_text_turn("assistant")
        return np.concatenate([sysprompt, user, assistant_prefix], axis=1)

    def __call__(self, input: str, voice: Optional[str] = "heart",
                 speaker: Optional[np.ndarray] = None) -> np.ndarray:
        """Synthesize `input` -> flattened PCM float array. The KV history is
        bf16 whatever `quantize` says, as in the JAX package."""
        from smoltts_torch.codec.mimi import mimi_decode
        from smoltts_torch.lm.generate import generate_blocking

        prompt = self._get_prompt(input, voice or "heart", sysprompt=speaker)
        codes, n_frames, _ = generate_blocking(self.params, self.config, self.token_config,
                                               self.generation_settings, [prompt],
                                               generator=self.generator, device=self.device)
        n = int(n_frames[0])
        if n == 0 or self.codec_params is None:
            return np.zeros((0,), np.float32)
        pcm = mimi_decode(self.codec_params, self.codec_config,
                          torch.from_numpy(codes[:, :, :n]).to(self.device))
        return _pcm_numpy(pcm)

    def _own_stream_states(self) -> bool:
        """Take the instance's B=1 vocoder and LM states; False while another
        open stream holds them."""
        with self._stream_states_lock:
            if self._stream_states_taken:
                return False
            self._stream_states_taken = True
            return True

    def _stream_mimi_state(self):
        """The instance's B=1 vocoder state, reset in place."""
        from smoltts_torch.codec.mimi import reset_stream_state

        if self._stream_mimi is None:
            self._stream_mimi = self._new_stream_mimi()
            return self._stream_mimi
        return reset_stream_state(self._stream_mimi)

    def _stream_lm_state(self):
        """The instance's B=1 LM decode state, reset in place."""
        from smoltts_torch.lm.decode import reset_decode_state

        if self._stream_lm is None:
            self._stream_lm = self._new_stream_lm()
            return self._stream_lm
        return reset_decode_state(self._stream_lm)

    def _new_stream_lm(self):
        from smoltts_torch.lm.decode import init_decode_state

        return init_decode_state(self.config, 1, self.config.max_seq_len, dtype=self.kv_dtype,
                                 device=self.device)

    def _new_stream_mimi(self):
        from smoltts_torch.codec.mimi import decode_stream_init

        kv8 = self.kv_dtype == torch.int8
        return decode_stream_init(self.codec_config, batch=1,
                                  kv_dtype=torch.int8 if kv8 else None, device=self.device)

    def stream(self, input: str, voice: Optional[str] = "heart") -> Iterator[np.ndarray]:
        """Yield 80 ms PCM chunks as frames decode. Every generated frame is
        vocoded, as in the reference."""
        from smoltts_torch.lm.generate import pad_prompts
        from smoltts_torch.lm.graph import keep_in_place
        from smoltts_torch.lm.pipeline import (
            flush_cadence,
            make_flush_step,
            make_prefill_step,
            make_stream_step,
        )

        if self.codec_params is None:
            raise RuntimeError("no Mimi weights loaded; pass mimi_path")
        dev = self.device
        prompt = self._get_prompt(input, voice or "heart")
        owned = self._own_stream_states()
        try:
            mstate = self._stream_mimi_state() if owned else self._new_stream_mimi()
            lm = self._stream_lm_state() if owned else self._new_stream_lm()
            args = (self.config, self.token_config, self.generation_settings, self.codec_config)
            vocoder = self._vocoder if owned else None
            prefill_step = make_prefill_step(*args, device=dev, vocoder=vocoder)
            stream_step = make_stream_step(*args, device=dev, vocoder=vocoder,
                                           lm_frame=self._lm_frame if owned else None)
            padded, lens = pad_prompts([prompt])
            state, mstate, gen, out = prefill_step(self.params, self.codec_params, lm, mstate,
                                                   torch.from_numpy(padded).to(dev),
                                                   torch.from_numpy(lens).to(dev), self.generator)
            state = keep_in_place(lm, state)  # the prefill renews the small leaves
            yield _pcm_to_host(out.pcm)
            flush_step = make_flush_step(device=dev)
            cadence = flush_cadence(state, mstate)
            since_flush = 0
            for _ in range(self.generation_settings.max_new_tokens - 1):
                if bool(out.finished[0]):
                    break
                if since_flush >= cadence:
                    state, mstate = flush_step(state, mstate)
                    since_flush = 0
                state, mstate, gen, out = stream_step(self.params, self.codec_params, state,
                                                      mstate, gen)
                since_flush += 1
                yield _pcm_to_host(out.pcm)
        finally:
            if owned:
                with self._stream_states_lock:
                    self._stream_states_taken = False

    def create_speaker(self, samples: List[dict], system_prompt: Optional[str] = None) -> np.ndarray:
        """A voice-cloning conditioning prompt from (text, audio) samples, by
        Mimi-encoding the reference audio."""
        from smoltts_torch.codec.mimi import mimi_encode

        if self.codec_params is None:
            raise RuntimeError("no Mimi weights loaded; pass mimi_path")
        turns = []
        for sample in samples:
            if "audio" not in sample or "text" not in sample:
                raise ValueError(
                    f"Sample must contain both 'text' and 'audio' but got {sample.keys()}")
            user_prompt = self.prompt_encoder.encode_text_turn("user", sample["text"])
            audio = torch.from_numpy(np.asarray(sample["audio"], np.float32).reshape(1, -1))
            codes = mimi_encode(self.codec_params, self.codec_config, audio.to(self.device),
                                num_quantizers=8)
            turns.append(user_prompt)
            turns.append(self.prompt_encoder.encode_vq(codes[0].cpu().numpy()))
        if system_prompt is not None:
            turns = [self.prompt_encoder.encode_text_turn("system", system_prompt), *turns]
        return np.concatenate(turns, axis=1)
