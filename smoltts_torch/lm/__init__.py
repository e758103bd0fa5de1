"""DualAR language-model decoding: prompts, sampling, the cached frame step
and the streaming pipeline."""
