"""Multi-process serving and training over torch.distributed: the device
mesh, the partition specs and collectives (`mesh.py`), collectives that
carry gradients for training (`collectives.py`), the serving layout of the
decode and vocoder state (`serving.py`), and a rank launcher with a
wall-clock limit (`launch.py`)."""
