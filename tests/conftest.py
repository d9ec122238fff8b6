"""Shared test plumbing.

``run_distributed`` is the single place that builds the forced-host-
device environment for distributed subprocess tests: the 8-device
``XLA_FLAGS`` goes into the *child's environment* (previously every
snippet carried its own fragile ``os.environ["XLA_FLAGS"] = ...`` line
that had to run before the first jax import), and a prologue asserts
the 8-device view actually materialized — a snippet silently running on
1 device would pass every parity check without testing a collective.
"""
import os
import pathlib
import subprocess
import sys

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")

#: Device count every distributed subprocess test sees (the CI ``dist``
#: lane forces the same number for the in-process tests it runs).
DEVICE_COUNT = 8


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (subprocess / multi-device)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips when "
        "torch.cuda.is_available() is False")


def run_distributed(code: str, timeout=600, device_count: int = DEVICE_COUNT):
    """Run ``code`` in a subprocess seeing ``device_count`` forced host
    devices; asserts the device view before the snippet runs and a zero
    exit code after.  Returns the child's stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={device_count}")
    prologue = (
        "import jax\n"
        f"assert jax.device_count() == {device_count}, (\n"
        f"    'forced host devices did not materialize: '\n"
        f"    f'{{jax.device_count()}} != {device_count}')\n")
    r = subprocess.run([sys.executable, "-c", prologue + code],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout
