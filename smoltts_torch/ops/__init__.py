"""Kernels of the decode path and their plain PyTorch versions.

Each kernel wrapper takes its plain version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card (or raises). `LAUNCHES`
counts kernel launches, one per wrapper call that launched.
"""

LAUNCHES = {"fast_loop": 0, "decode_attention": 0, "sample_categorical": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
