"""Seconds of audio delivered to clients per second of the window: every
PCM frame that reached a client inside the window."""

from portbench.metrics._serve import seconds_per_frame, window_arrivals


def read(ctx):
    return len(window_arrivals(ctx)) * seconds_per_frame(ctx) / ctx["window_s"]
