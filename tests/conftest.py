"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU so that it gives the same answers on any host,
card or no card, and so that the multi-device paths (mesh codec,
distributed driver) are checked on eight virtual devices.  Tests that need
the card carry the `gpu` marker and take the `gpu` fixture below, which
skips them on a host without one; on a machine with a card they run with

    python -m pytest tests/ -m gpu -p no:xdist

Each such test does its card work in a child process, so this process
stays on the CPU and never holds card memory.
"""
import os
import subprocess
import sys

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()
import jax  # noqa: E402

# the environment variable is read when jax is imported; the config update
# also holds if something imported jax before this file
jax.config.update("jax_platforms", "cpu")

# The full suite loads hundreds of XLA CPU executables in one process; each
# mmaps many regions and the kernel default vm.max_map_count=65530 overflows
# late in the run (LLVM then segfaults inside backend_compile_and_load).
# Best-effort raise (works when running as root; harmless otherwise); the
# original value is restored when the test session ends so the host-wide
# sysctl change does not outlive the run.  Opt out: DSRC_TPU_NO_SYSCTL=1.
_orig_map_count = None
if not os.environ.get("DSRC_TPU_NO_SYSCTL"):
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            _orig_map_count = int(f.read())
        if _orig_map_count < 500_000:
            with open("/proc/sys/vm/max_map_count", "w") as g:
                g.write("2000000")
        else:
            _orig_map_count = None
    except OSError:
        _orig_map_count = None


def pytest_sessionfinish(session, exitstatus):
    if _orig_map_count is not None:
        try:
            with open("/proc/sys/vm/max_map_count", "w") as g:
                g.write(str(_orig_map_count))
        except OSError:
            pass


def card_env() -> dict:
    """Environment for a child process that should use the card: this
    process's settings with the CPU forcing replaced by CUDA, so a host
    without a card fails fast instead of falling back to the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="session")
def gpu():
    """Skip unless a child process finds a GPU as JAX's default device.
    Decided here, while the test runs — never at import or collection."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=card_env(), capture_output=True, text=True, timeout=300)
    lines = probe.stdout.split()
    if probe.returncode != 0 or not lines or lines[-1] != "gpu":
        pytest.skip("needs a GPU (JAX found none)")
    return card_env()
