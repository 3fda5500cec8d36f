import jax

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere"
    )
