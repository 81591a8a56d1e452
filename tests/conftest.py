import os
import sys

# Sharding tests need a real multi-device mesh: force 8 host-platform
# devices BEFORE any jax import locks the device count.  (The dry-run
# forces 512 in its own process; benches that want the host's true
# count can unset this.)
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel; needs an NVIDIA GPU and nvcc, "
                   "skipped (inside the test) where there is none")
