"""Device ms per vocoder step inside the served frame steps of the traced
sub-window: as `lm_device_ms_per_frame`, over the program's `codec.step`
spans."""

from portbench.program_spans import device_ms_per_frame


def read(ctx):
    return device_ms_per_frame(ctx, "codec.step")
