"""The LM frame (`decode_frame`: slow trunk, slow-token site, fast loop)
alone at the cell's batch and its most used attend bucket, device ms per
call by CUDA events, after the window."""


def read(ctx):
    return ctx.get("lm_frame_ms")
