"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-card hardware is not available where the tests run; sharding tests
use ``xla_force_host_platform_device_count`` (the standard JAX recipe for
validating Mesh/shard_map programs without real devices). The platform is
pinned to the CPU through ``jax.config`` before any backend initializes.

Tests that need the card carry the ``gpu`` marker and skip here; they run
on the GPU inside ``chip_smoke.py`` (which sets ``BT_GPU_TESTS=1`` so the
CPU pinning below stays off).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("BT_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")

# Keep the persistent compilation cache OFF for the whole test session.
# Tests compile hundreds of small CPU programs — the cache buys nothing
# here, and with that many executables in one process PJRT's
# LoadedExecutable.serialize() has segfaulted on a later cache write
# (observed on the multi-view shard_map step), killing the run.
jax.config.update("jax_enable_compilation_cache", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips on the CPU, runs on the card "
        "through chip_smoke.py",
    )


# --- VMA guard -------------------------------------------------------------
# Root cause of the intermittent late-suite segfaults: every live XLA:CPU
# executable holds ~10 small mmap'd JIT-code regions, and a full-suite run
# accumulates executables until the process hits the kernel's per-process
# mapping limit (vm.max_map_count, default 65530). When mmap starts
# failing, XLA's code emission segfaults instead of erroring. Releasing
# executables (del / jax.clear_caches()) returns the mappings. So: after
# each test, if the map count nears the limit, drop JAX's global caches —
# later tests recompile (slower, correct) instead of crashing the whole run.

_VMA_SOFT_LIMIT = 40_000


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux fallback: never trigger
        return 0


def pytest_runtest_teardown(item):
    if _map_count() > _VMA_SOFT_LIMIT:
        import gc

        jax.clear_caches()
        gc.collect()
