"""The whole served step's share of the chip's bf16 peak, in %: model
FLOPs of every frame delivered to a client inside the window (the LM frame
at the stream's context, and the vocoder frame; portbench/flops.py) over
its seconds x 989 TFLOP/s, the window taken less any traced sub-window."""

from portbench.flops import lm_frame_flops, vocoder_frame_flops
from portbench.metrics._serve import in_quiet, quiet_seconds
from portbench.peaks import BF16_FLOPS


def read(ctx):
    arrivals = [(r, i) for r in ctx.get("requests", []) for i, t in enumerate(r.arrivals)
                if in_quiet(ctx, t)]
    if not arrivals:
        return None
    voc = vocoder_frame_flops(ctx["codec"])
    total = sum(lm_frame_flops(ctx["model"], r.prompt.shape[1] + i) + voc for r, i in arrivals)
    return 100.0 * total / (quiet_seconds(ctx) * BF16_FLOPS)
