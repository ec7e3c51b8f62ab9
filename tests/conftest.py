def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc (the port's hand-written "
        "kernels); skipped where torch finds no CUDA device")
