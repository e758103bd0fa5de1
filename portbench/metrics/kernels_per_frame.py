"""Device ops (kernels, copies, fills) launched per frame by the LM frame
and the vocoder step inside the served frame steps of the traced
sub-window: those launched in the program's `lm.frame` and `codec.step`
spans there, over the number of frames."""

from portbench.program_spans import kernels_per_frame


def read(ctx):
    return kernels_per_frame(ctx)
