"""Host ms per vocoder step inside the served frame steps: the mean of the
program's `codec.step` spans that lie in a `step.chunk` or `step.stream`
span, inside the quiet stretches."""

from portbench.program_spans import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "codec.step")
