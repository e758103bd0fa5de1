"""The train step's share of the chip's bf16 peak, in %: model FLOPs of a
step (portbench/flops.py) x steps / (window seconds x 989 TFLOP/s), the
window taken less any traced steps."""

from portbench.flops import train_step_flops
from portbench.peaks import BF16_FLOPS


def read(ctx):
    if "steps" not in ctx:
        return None
    steps, secs = ctx.get("quiet_steps", ctx["steps"]), ctx.get("quiet_s", ctx["window_s"])
    if not steps:
        return None
    return 100.0 * train_step_flops(ctx["model"], ctx["batch"], ctx["seq"]) * steps / (
        secs * BF16_FLOPS)
