"""Host ms the engine's dispatcher spends inside `dispatch_step` per frame
step: `DecodeEngine.stats["dispatch_s"]` / `stats["frame_steps"]`
(program counters) over the quiet stretches. Admissions are dispatched
there too."""


def read(ctx):
    stats = ctx.get("stats", {})
    spent, steps = stats.get("dispatch_s"), stats.get("frame_steps")
    return spent * 1e3 / steps if spent and steps else None
