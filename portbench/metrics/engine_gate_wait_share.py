"""The engine dispatcher's time asleep with streams live because its
`max_ahead` gate is shut (it waits on fetch), as a share of the window, in
%: `DecodeEngine.stats["gate_wait_s"]` (a program counter) over the quiet
stretches."""

from portbench.metrics._serve import quiet_seconds


def read(ctx):
    waited = ctx.get("stats", {}).get("gate_wait_s")
    return 100.0 * waited / quiet_seconds(ctx) if waited else None
