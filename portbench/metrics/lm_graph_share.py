"""Share (%) of the LM frames inside the served frame steps that replay a
CUDA graph: the program's `lm.replay` spans that lie in its `lm.frame`
spans inside a `step.chunk` or `step.stream` span (a prefill's frame is not
counted), over those `lm.frame` spans, inside the quiet stretches. A frame
replays at most one graph. None where the program has no LM frame graphs
(`smoltts_torch.lm.graph`) or records no such frames."""

import importlib.util

from portbench.program_spans import FRAME_PARENTS, frame_parts, nested, quiet_spans


def read(ctx):
    try:
        if importlib.util.find_spec("smoltts_torch.lm.graph") is None:
            return None
    except ImportError:
        return None
    got = quiet_spans(ctx, ("lm.frame", "lm.replay") + FRAME_PARENTS)
    frames = [] if got is None else frame_parts(got, "lm.frame")
    if not frames:
        return None
    replays = nested([s for s in got if s[0] == "lm.replay"], frames)
    return 100.0 * len(replays) / len(frames)
