from tests import native_build


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's hand-written kernels); "
        "skips inside the test when none is present",
    )
    # in the xdist controller (or a run without workers), before any worker
    # imports the JAX package's native runtime
    if not hasattr(config, "workerinput"):
        native_build.build_once()

