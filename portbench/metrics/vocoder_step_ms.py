"""The vocoder step (`mimi_decode_step` of one frame) alone at the cell's
batch, device ms per call by CUDA events, after the window."""


def read(ctx):
    return ctx.get("vocoder_step_ms")
