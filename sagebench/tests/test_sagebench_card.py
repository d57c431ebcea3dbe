"""One short run of a cell on the card, through ``sagebench/run.py``: it
prints a result whose ``correct`` is true. On a machine without a card it
skips. On the card: ``PYTHONPATH=src python -m pytest --noconftest -q -m
requires_cuda sagebench/tests/test_sagebench_card.py``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", ["olmoe-1b-7b.warm", "mamba2-780m.saturate"])
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run([sys.executable, "sagebench/run.py", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result
    assert result["device"]["platform"] == "gpu" and result["metrics"]["setup_s"]["value"] > 0
