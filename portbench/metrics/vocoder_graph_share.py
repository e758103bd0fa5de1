"""Share (%) of the vocoder steps inside the served frame steps that replay
a CUDA graph: the program's `codec.replay` spans that lie in its
`codec.step` spans inside a `step.chunk` or `step.stream` span (a prefill's
vocoder step is not counted), over those `codec.step` spans, inside the
quiet stretches. A step replays at most one graph. None where the program
has no vocoder graphs (`smoltts_torch.codec.graph`) or records no such
steps."""

import importlib.util

from portbench.program_spans import FRAME_PARENTS, frame_parts, nested, quiet_spans


def read(ctx):
    try:
        if importlib.util.find_spec("smoltts_torch.codec.graph") is None:
            return None
    except ImportError:
        return None
    got = quiet_spans(ctx, ("codec.step", "codec.replay") + FRAME_PARENTS)
    steps = [] if got is None else frame_parts(got, "codec.step")
    if not steps:
        return None
    replays = nested([s for s in got if s[0] == "codec.replay"], steps)
    return 100.0 * len(replays) / len(steps)
