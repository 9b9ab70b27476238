"""Test harness setup.

Mirrors the reference test strategy (SURVEY.md §4): the reference runs a real Spark
context with master=local[*] and 8 RDD partitions to exercise distributed paths in one
JVM (UniformRandomWalkTest.scala:12-24,187); we force an 8-device virtual CPU mesh the
same way. x64 is enabled so exact-parity tests against the float64 NumPy oracle are
numerically stable (the production path runs float32; parity at f32 is validated
distributionally).

The platform is forced through jax.config (not only the environment) because jax may
already be imported when pytest loads this file; it must be set before the backend
initializes lazily. Tests that need a card do not run here: they run on the machine
with the card, through `chip_smoke.py`.
"""

import os

import jax

assert not jax._src.xla_bridge._backend_lock.locked()
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# nothing compiled here is persisted: the CLI points the cache at the checkout
jax.config.update("jax_enable_compilation_cache", False)

# Keep subprocesses (if any test spawns them) on the CPU too.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["PYTHONPATH"] = ""

import pytest  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="session", autouse=True)
def _check_cpu_mesh():
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert jax.device_count() == 8, jax.devices()
    yield


@pytest.fixture(scope="session")
def karate_path():
    return os.path.join(DATA, "karate.txt")


@pytest.fixture(scope="session")
def testgraph_path():
    return os.path.join(DATA, "testgraph.txt")
