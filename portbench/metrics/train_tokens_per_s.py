"""Training tokens per second: steps completed in the window x batch x
sequence length / window seconds (host clock, a synchronize at the
close)."""


def read(ctx):
    if "steps" not in ctx or not ctx["steps"]:
        return None
    return ctx["steps"] * ctx["batch"] * ctx["seq"] / ctx["window_s"]
