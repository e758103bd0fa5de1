"""Training: losses, data, the AdamW optimizer with optax's arithmetic, the
train step and loop, checkpoints, and the CLI (`python -m
smoltts_torch.train.main`)."""
