"""Test configuration: a CPU backend with 8 virtual devices (for sharding
tests) and float64 enabled (golden-parity tolerances need it).

Pallas kernels run here in interpret mode (``interpret=True``). Tests marked
``gpu`` need a card; they decide inside the ``gpu_device`` fixture whether one
is present, skip here, and run on the card from ``chip_smoke.py``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("GRADUS_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from gradus_tpu.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compile cache, read-only in the test process: the integrator
# while_loop compiles in tens of seconds on a small CPU and module-scoped
# fixtures recompile it per file, but XLA:CPU `executable.serialize()` has
# crashed intermittently inside long pytest runs, so tests never write
# entries (min compile time 1e9 s).
enable_compile_cache(min_compile_time_secs=1e9)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return devs[0]


def pytest_report_header(config):
    return f"jax backend: {jax.default_backend()}, devices: {jax.device_count()}"
