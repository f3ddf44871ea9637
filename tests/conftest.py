"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
exercised without an accelerator (SURVEY.md §4: "multi-chip tests runnable
on CPU via jax device-count override"). Tests that need a GPU carry the
`gpu` marker and skip here; chip_smoke.py runs the same flows on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Pin the platform via jax.config before any test imports jax (tests run on
# the virtual CPU mesh even where an accelerator is present).
import jax  # noqa: E402
import pytest  # noqa: E402

# ZKAES_TEST_GPU=1 leaves the platform alone so `-m gpu` tests can reach
# a card
if os.environ.get("ZKAES_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with ZKAES_TEST_GPU=1 on the card")
