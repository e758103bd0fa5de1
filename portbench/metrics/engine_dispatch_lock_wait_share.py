"""The engine dispatcher's wait for the engine lock as a share of the
window, in %: `DecodeEngine.stats["lock_wait_s.dispatch"]` (a program
counter, kept by the EngineLoop's timed lock) over the quiet stretches."""

from portbench.metrics._serve import quiet_seconds


def read(ctx):
    waited = ctx.get("stats", {}).get("lock_wait_s.dispatch")
    return 100.0 * waited / quiet_seconds(ctx) if waited else None
