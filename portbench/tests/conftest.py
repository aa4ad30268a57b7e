"""The benchmark's own tests: ``python -m pytest portbench/tests``.  The
driver's ``pytest tests/`` does not collect them."""


def pytest_configure(config):
    import torch

    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")
    # a few threads: the CPU runs are small and the machine is shared
    torch.set_num_threads(4)
