"""PyTorch/CUDA port of smoltts: the DualAR text-to-speech decoder and the
Mimi codec on an NVIDIA Hopper card, behind the library API `SmolTTS`
(smoltts_torch/api.py).

The package imports torch and numpy only. Its three hand-written CUDA kernels
(`csrc/*.cu`) are compiled with nvcc at first use into `build/smoltts_torch/`;
importing the package builds nothing. Entry points take `device=None`, which
means "cuda", and raise when no card is present unless `device="cpu"` is given.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; a CUDA request on a host with no card raises (the
    port never falls back to the CPU silently)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "smoltts_torch: no CUDA device available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev


def __getattr__(name):
    # `SmolTTS` and `VOICES` live in smoltts_torch.api, imported on first use
    # so that `import smoltts_torch` stays free of the model and codec.
    if name in ("SmolTTS", "VOICES"):
        from smoltts_torch import api

        return getattr(api, name)
    raise AttributeError(f"module 'smoltts_torch' has no attribute {name!r}")
