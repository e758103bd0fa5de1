"""The closed loop's first-audio tail: first_audio_ms_p95's reading, a
per-layer metric in a cell at capacity, where the tail swings with the
queue for the engine."""

from portbench.registry import reader

read = reader("first_audio_ms_p95")
