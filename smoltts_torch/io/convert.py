"""Checkpoint conversion to the release layout (`model.safetensors` +
`config.json`, the depthwise head flattened), with the port's own writer:

    python -m smoltts_torch.io.convert --src <path> --config <config.json> -o out/
        [--dtype float32|bfloat16|keep] [--device cuda|cpu]

Sources: a train step dir of the port (`step_NNNNNN/` with `state.pt`), a
torch `.pt`/`.pth` (raw or with `model_state_dict`), a safetensors file, or a
dir holding one of them. An Orbax step dir of the JAX trainer is refused:
the port reads no Orbax.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Union

import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig
from smoltts_torch.interop import tree_map
from smoltts_torch.io.checkpoint import params_from_state_dict, save_params
from smoltts_torch.io.safetensors import load_file
from smoltts_torch.train.checkpoint import STATE_FILE
from smoltts_torch.train.optim import tree_leaves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_source(src: Path, cfg: DualARConfig) -> dict:
    """The parameter tree of a source, on the CPU."""
    if src.is_dir():
        if (src / STATE_FILE).exists():  # the port's train step dir
            ckpt = torch.load(src / STATE_FILE, map_location="cpu", weights_only=True)
            return ckpt["params"]
        if (src / "state").exists():
            raise ValueError(
                f"{src} is an Orbax train checkpoint of the JAX package; the port reads no "
                "Orbax. Convert it with `python -m smoltts_tpu.io.convert` first, then load "
                "the safetensors it writes")
        for name in ("model.safetensors", "model.pth", "model.pt"):
            if (src / name).exists():
                src = src / name
                break
        else:
            raise FileNotFoundError(f"no checkpoint found in {src}")
    if src.suffix == ".safetensors":
        return params_from_state_dict(load_file(src), cfg)
    if src.suffix in (".pt", ".pth"):
        raw = torch.load(src, map_location="cpu", weights_only=True)
        if "model_state_dict" in raw:
            raw = raw["model_state_dict"]
        return params_from_state_dict({k: v.to(torch.float32) for k, v in raw.items()}, cfg)
    raise ValueError(f"unsupported source {src}")


def convert(src: Union[str, Path], config: Union[str, Path], out_dir: Union[str, Path],
            dtype: str = "keep", device=None) -> int:
    """Write the release layout of `src` into `out_dir`; returns the number
    of parameters. `device=None` means CUDA (checked before any file is
    read); a dtype conversion runs there."""
    dev = resolve_device(device)
    cfg = DualARConfig.from_json_file(config)
    params = tree_map(lambda t: t.to(dev), load_source(Path(src), cfg))
    if dtype != "keep":
        params = tree_map(lambda t: t.to(DTYPES[dtype]), params)
    save_params(tree_map(lambda t: t.cpu(), params), cfg, out_dir)
    return sum(t.numel() for t in tree_leaves(params))


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(description="Convert checkpoints to the release safetensors layout")
    parser.add_argument("--src", required=True, help="train step dir, .pt/.pth, safetensors, or a dir")
    parser.add_argument("--config", required=True, help="model config.json (or dir containing it)")
    parser.add_argument("-o", "--out-dir", required=True)
    parser.add_argument("--dtype", choices=["float32", "bfloat16", "keep"], default="keep")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    n = convert(args.src, args.config, args.out_dir, args.dtype, args.device)
    print(f"Wrote {args.out_dir}/model.safetensors ({n} params)")


if __name__ == "__main__":
    main()
