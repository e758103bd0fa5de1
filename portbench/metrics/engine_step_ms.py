"""Window seconds per frame step the engine dispatched in it
(`DecodeEngine.stats["frame_steps"]`, a program counter), over the window
less any traced sub-window."""

from portbench.metrics._serve import quiet_seconds


def read(ctx):
    steps = ctx.get("stats", {}).get("frame_steps")
    return quiet_seconds(ctx) * 1e3 / steps if steps else None
