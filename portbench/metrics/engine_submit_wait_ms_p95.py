"""95th percentile of a client's wait for the engine lock in
`EngineLoop.submit` (the program's `engine.submit_wait` spans: from the
call to the lock held), over the spans inside the quiet stretches, in ms.
The engine's own queue wait starts after it."""

from portbench.program_spans import quiet_spans
from portbench.stats import percentile


def read(ctx):
    got = quiet_spans(ctx, ("engine.submit_wait",))
    return percentile([(s[2] - s[1]) * 1e3 for s in got], 95) if got else None
