"""Multi-process serving over torch.distributed: the device mesh, the
partition specs and collectives (`mesh.py`), the serving layout of the
decode and vocoder state (`serving.py`), and a rank launcher with a
wall-clock limit (`launch.py`)."""
