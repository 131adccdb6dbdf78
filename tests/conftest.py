"""Test config: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's `noasm`/`VECGO_SIMD=generic` testing strategy
(SURVEY.md §4): the device code runs through XLA:CPU against NumPy/jnp
references. GPU evidence comes from `chip_smoke.py`; tests that need the card
carry the `gpu` marker and skip here (the `gpu_device` fixture).

Must set env BEFORE jax is imported anywhere.
"""

import os

# CPU unless the caller names a platform (on the card:
# JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/).
_platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _platforms)

# Persistent compile cache: the suite is compile-dominated (graph-search
# programs); repeat runs hit the cache.
from vecgo.utils.jaxcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import faulthandler  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Per-test watchdog: the suite must TERMINATE, always (SURVEY §4 — it doubles
# as the concurrency harness). Round 3 found an order-dependent livelock: a
# mesh-collective test hung forever (all threads in futex_wait) when the
# jax-0.9.0 executable-reuse bug (utils/devbug.py) poisoned one mesh
# participant. A deadlocked collective never raises, and SIGALRM can't
# interrupt a C-level futex wait — so the watchdog is a plain thread that
# dumps all stacks and hard-exits the process when a single test exceeds the
# budget. Override with VECGO_TEST_TIMEOUT_S (0 disables).
# ---------------------------------------------------------------------------
_TEST_TIMEOUT_S = float(os.environ.get("VECGO_TEST_TIMEOUT_S", 600))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if _TEST_TIMEOUT_S <= 0:
        yield
        return

    def _abort():
        sys.stderr.write(
            f"\n\n=== WATCHDOG: test {item.nodeid} exceeded "
            f"{_TEST_TIMEOUT_S:.0f}s — dumping stacks and aborting ===\n"
        )
        sys.stderr.flush()
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
        os._exit(70)

    timer = threading.Timer(_TEST_TIMEOUT_S, _abort)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none (decided at run
    time, never at import, so every xdist worker collects the same tests)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return devs[0]


@pytest.fixture
def tmp_db_dir(tmp_path):
    return str(tmp_path / "db")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
