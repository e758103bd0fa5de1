"""One intra-op thread for the port's CPU tests: the suite runs several
workers on one host, each with JAX's host thread pool beside it, and torch's
default of one thread per core in every worker oversubscribes the host. The
port's test tensors are too small to gain from more threads. Every
`tests/test_torch_*.py` imports this module."""

import torch

torch.set_num_threads(1)
