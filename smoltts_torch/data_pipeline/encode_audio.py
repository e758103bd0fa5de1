"""Audio -> Mimi codes dataset encoder, on the port's batch Mimi encoder.

As the JAX package's `data_pipeline/encode_audio.py`: pad a batch of
utterances to a bucketed length, run the Mimi encoder once, keep the first
`num_codebooks` levels, and trim each row to `ceil(samples / 1920)` frames.
Also the `MimiCodec` wrapper (encode / encode_batch / decode) and a
sharded, resumable CLI:

    python -m smoltts_torch.data_pipeline.encode_audio --dataset-path in_dir \\
        --out-path out_dir --mimi-path mimi.safetensors [--device cpu]

`--device` defaults to CUDA, as every entry point of the port.
"""

from __future__ import annotations

import argparse
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.mimi import mimi_decode, mimi_encode
from smoltts_torch.interop import tree_map


def get_target_length(num_samples: int, samples_per_frame: int = 1920) -> int:
    return math.ceil(num_samples / samples_per_frame)


class MimiCodec:
    """encode / decode over the port's Mimi on `device` (None means CUDA;
    raises without a card)."""

    def __init__(self, params=None, config: Optional[MimiConfig] = None,
                 num_codebooks: int = 8, device=None):
        self.device = resolve_device(device)
        self.config = config or MimiConfig()
        if params is None:
            raise ValueError("pass Mimi params (load_mimi / init_mimi_params)")
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.num_codebooks = num_codebooks

    def _encode(self, batch: np.ndarray) -> np.ndarray:
        audio = torch.from_numpy(batch).to(self.device)
        codes = mimi_encode(self.params, self.config, audio, num_quantizers=self.num_codebooks)
        return codes.cpu().numpy()

    def encode(self, audio: np.ndarray) -> np.ndarray:
        """Mono float audio [L] -> codes [num_codebooks, T]."""
        audio = np.asarray(audio, np.float32).reshape(1, -1)
        T = get_target_length(audio.shape[-1], self.config.samples_per_frame)
        return self._encode(audio)[0, :, :T]

    def encode_batch(
        self, audios: Sequence[np.ndarray], bucket_multiple: int = 1
    ) -> List[np.ndarray]:
        """Pad to the batch max (bucketed to whole frames), encode once, trim
        each row to its own frame count."""
        spf = self.config.samples_per_frame
        lens = [int(np.asarray(a).shape[-1]) for a in audios]
        max_len = max(lens)
        bucket = spf * bucket_multiple
        max_len = ((max_len + bucket - 1) // bucket) * bucket
        batch = np.zeros((len(audios), max_len), np.float32)
        for i, a in enumerate(audios):
            batch[i, : lens[i]] = np.asarray(a, np.float32).flatten()
        codes = self._encode(batch)
        return [codes[i, :, : get_target_length(n, spf)] for i, n in enumerate(lens)]

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes [num_codebooks, T] -> mono float audio [T * spf]."""
        c = torch.from_numpy(np.asarray(codes, np.int64)).to(self.device)[None]
        pcm = mimi_decode(self.params, self.config, c)
        return pcm[0, :, 0].float().cpu().numpy()


def encode_dataset_rows(
    codec: MimiCodec, rows: List[dict], audio_key: str = "audio", batch_size: int = 24
) -> List[dict]:
    """Encode a list of {audio: {array, sampling_rate} | ndarray} rows."""
    out = []
    for start in range(0, len(rows), batch_size):
        chunk = rows[start : start + batch_size]
        audios = []
        for r in chunk:
            a = r[audio_key]
            audios.append(np.asarray(a["array"] if isinstance(a, dict) else a, np.float32))
        codes = codec.encode_batch(audios)
        for r, c in zip(chunk, codes):
            row = {k: v for k, v in r.items() if k != audio_key}
            row["codes"] = c
            out.append(row)
    return out


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description="Mimi-encode an audio dataset")
    parser.add_argument("--dataset-path", type=str, required=True)
    parser.add_argument("--out-path", type=str, required=True)
    parser.add_argument("--mimi-path", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=24)
    parser.add_argument("--num-codebooks", type=int, default=8)
    parser.add_argument("--shards", type=int, default=1)
    parser.add_argument(
        "--skip-shards", type=int, default=0, help="resume: skip completed shards"
    )
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    from datasets import Dataset, load_from_disk

    from smoltts_torch.codec.mimi import load_mimi

    params, cfg = load_mimi(args.mimi_path, device=dev)
    codec = MimiCodec(params, cfg, num_codebooks=args.num_codebooks, device=dev)

    dataset = load_from_disk(args.dataset_path)
    for i in range(args.skip_shards, args.shards):
        shard = dataset.shard(args.shards, i) if args.shards > 1 else dataset
        rows = encode_dataset_rows(
            codec, [shard[j] for j in range(len(shard))], batch_size=args.batch_size
        )
        out = Dataset.from_list(rows)
        suffix = f"_shard{i:03d}" if args.shards > 1 else ""
        out.save_to_disk(args.out_path + suffix)
        print(f"shard {i + 1}/{args.shards} done ({len(rows)} rows)")


if __name__ == "__main__":
    main()
