"""K1's share of its roofline in the traced sub-window: the bound of every
K1 call (portbench/rooflines/k1.py, at the call's rows) over its device
time, from its first kernel's start to its last kernel's end, summed over
the calls, in %. A call's rows: the admitted prompts in an admission, the
engine's slots in a frame step."""

from portbench.peaks import bound_seconds
from portbench.rooflines import k1
from portbench.tracing import call_spans


def read(ctx):
    trace, log = ctx.get("trace"), ctx.get("probe_log")
    if trace is None or log is None:
        return None
    bound = spent = 0.0
    for kind in ("admit", "advance"):
        for i, ks in trace.kernels_in(kind).items():
            ks = [k for k in ks if k1.KERNELS.search(k.name)]
            meta = log[i]
            rows, calls = (meta[1], 1) if kind == "admit" else (ctx["num_slots"], meta[1])
            times = call_spans(ks, calls)
            if not times:
                continue
            bound += calls * bound_seconds(*reversed(k1.work(ctx["model"], rows)))
            spent += sum(times)
    return 100.0 * bound / spent if spent > 0 else None
