import os
import sys
from pathlib import Path

# tests see ONE device (the dry-run alone forces 512 — per assignment).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: threaded-runtime scenario tests (~10s wall each)")
    config.addinivalue_line(
        "markers", "requires_cuda: needs an NVIDIA card and nvcc (skips "
        "without them); run on the card with -m requires_cuda")
