"""File formats of the port: safetensors, release-format checkpoints, WAV, G.711, MPEG audio."""
