"""The closed loop's frame-interval tail: frame_interval_ms_p95's reading,
a per-layer metric in a cell at capacity."""

from portbench.registry import reader

read = reader("frame_interval_ms_p95")
