def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's hand-written kernels); "
        "skips inside the test when none is present",
    )
