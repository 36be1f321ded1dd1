"""pytest settings of the benchmark's own tests (`pytest benchmark/tests`):
the marker of the tests that need the card, and two threads a worker."""


def pytest_configure(config):
    import torch

    # the tests run side by side in several workers, each with its runs in
    # subprocesses: two threads apiece keep the CPU from being oversubscribed
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; the test itself decides whether one is there "
                   "and skips without it")
