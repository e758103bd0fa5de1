"""K2's (tuned route) share of its roofline in the traced sub-window: the
bound of every call (portbench/rooflines/k2.py, over the positions valid in
each slot at that frame) over the kernel's device time, summed over the
frame steps' calls, in %."""

from portbench.peaks import bound_seconds
from portbench.rooflines import k2


def read(ctx):
    trace, log = ctx.get("trace"), ctx.get("probe_log")
    if trace is None or log is None:
        return None
    n_layer = ctx["model"]["n_layer"]
    bound = spent = 0.0
    for i, ks in trace.kernels_in("advance").items():
        ks = [k for k in ks if k2.KERNELS.search(k.name)]
        _, K, _, frames = log[i]
        if len(ks) != K * n_layer:
            continue
        for j, k in enumerate(ks):
            n_hist, n_tail = frames[j // n_layer]
            flops, nbytes = k2.work(ctx["model"], ctx["num_slots"], n_hist, n_tail,
                                    ctx["tail_len"])
            bound += bound_seconds(nbytes, flops)
            spent += (k.t1 - k.t0) / 1e6
    return 100.0 * bound / spent if spent > 0 else None
