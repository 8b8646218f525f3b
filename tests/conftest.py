import jax
import pytest

try:  # pragma: no cover - depends on container contents
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_stub

    _hypothesis_stub.install()

# Tests run on the single host CPU device (the dry-run forces 512 devices
# in its own process only — never here).
jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
