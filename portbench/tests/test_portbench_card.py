"""On the card (skipped elsewhere): every cell of BENCHMARK.json runs a
short window at its own sizes, untraced and traced, and is correct."""
import json
import os
import subprocess
import sys

import pytest

from conftest import CODE, ROOT


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", _cells())
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, os.path.join(CODE, "run.py"), "--workload", cell,
                          "--seed", "3000000321", "--seconds", "3", "--trace", trace],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-2000:]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace == "1":
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
