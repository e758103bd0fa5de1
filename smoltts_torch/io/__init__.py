"""File formats of the port: safetensors, release-format checkpoints, WAV."""
