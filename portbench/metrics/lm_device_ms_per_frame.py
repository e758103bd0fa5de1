"""Device ms per LM frame inside the served frame steps of the traced
sub-window: for each of the program's `lm.frame` spans there (moved onto
the trace's clock, portbench/program_spans.py), the union of the device
intervals of the ops it launched; the mean over the frames."""

from portbench.program_spans import device_ms_per_frame


def read(ctx):
    return device_ms_per_frame(ctx, "lm.frame")
