"""Test configuration: all tests run on a virtual 8-device CPU mesh so
sharding tests work without several accelerators (chip_smoke.py and
bench.py run on the GPU outside pytest).  ``jax.config.update`` forces the
CPU even where ``JAX_PLATFORMS`` names another platform.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def small_config():
    from raytpu.core.types import RenderConfig

    return RenderConfig(width=64, height=48)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Bound compile-cache/RSS growth across the 13 test modules: a full-suite
    run once segfaulted inside XLA:CPU's compiler near the end of the suite
    (flaky, not reproducible standalone) — keep per-module jit caches from
    accumulating."""
    yield
    jax.clear_caches()
