"""PyTorch/CUDA port of smoltts: the DualAR text-to-speech decoder and the
Mimi streaming vocoder on an NVIDIA Hopper card.

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
