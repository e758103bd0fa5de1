"""Host ms per LM frame inside the served frame steps: the mean of the
program's `lm.frame` spans that lie in a `step.chunk` or `step.stream`
span (not a prefill), inside the quiet stretches: the host's time issuing
the frame, and waiting where it syncs."""

from portbench.program_spans import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "lm.frame")
