"""Test configuration: run on a virtual 8-device CPU mesh.

XLA flags must be set before JAX initialises a backend.  Tests marked
`gpu` need a card: the `gpu` fixture skips them elsewhere, and
chip_smoke.py runs them on the card in its own process (it sets
XRSFM_CARD_TESTS so that the platform is left alone here).
"""

import os

import pytest

if not os.environ.get("XRSFM_CARD_TESTS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")
    return jax.devices()[0]
