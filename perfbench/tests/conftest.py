"""Few torch threads per test process: the suite runs in several workers,
and the plain passes oversubscribe the cores at torch's default."""

import torch


def pytest_configure(config):
    torch.set_num_threads(2)
