"""What the serving metrics share: the window's requests and frames as the
client saw them."""

from portbench.reference.mimi import samples_per_frame


def in_window(ctx, t):
    return ctx["t_open"] <= t < ctx["t_close"]


def window_requests(ctx):
    """Requests whose latency starts inside the window."""
    return [r for r in ctx.get("requests", []) if r.start is not None and in_window(ctx, r.start)]


def window_arrivals(ctx):
    """(request, frame index) of every frame that reached the client inside
    the window."""
    return [(r, i) for r in ctx.get("requests", []) for i, t in enumerate(r.arrivals)
            if in_window(ctx, t)]


def seconds_per_frame(ctx) -> float:
    return samples_per_frame(ctx["codec"]) / ctx["codec"]["sampling_rate"]


def quiet(ctx):
    """The stretches of the window outside a traced sub-window (the whole
    window when nothing was traced)."""
    return ctx.get("quiet") or [(ctx["t_open"], ctx["t_close"])]


def in_quiet(ctx, t0, t1=None):
    """Whether [t0, t1] lies inside one quiet stretch."""
    t1 = t0 if t1 is None else t1
    return any(a <= t0 and t1 < b for a, b in quiet(ctx))


def quiet_seconds(ctx) -> float:
    return sum(b - a for a, b in quiet(ctx))
