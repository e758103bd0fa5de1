"""DualAR language-model decoding: prompts, sampling, the cached frame step,
the streaming pipeline and the continuous-batching engine (lm/engine.py)."""
