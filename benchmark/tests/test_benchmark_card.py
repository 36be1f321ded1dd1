"""On the card: one short run of a cell through the command itself. Skips
where there is no CUDA device (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["mandelbulb.frames"])
def test_a_short_run_on_the_card_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed",
                        "2718281828459", "--seconds", "2", "--trace", "0"], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=1200,
                       env=dict(os.environ, USE_FLAX="0"))
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
