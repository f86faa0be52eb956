import os

import pytest

# Tests run on the CPU unless JAX_PLATFORMS names a platform: semantics
# are checked on an 8-device virtual CPU mesh. `JAX_PLATFORMS=cuda
# python -m pytest -m gpu tests/` runs the tests that need the GPU.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda)")
    return devs[0]
