"""mlmc_tpu_torch stands alone: it imports neither jax nor mlmc_tpu, and a
CUDA request never runs on the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mlmc_tpu_torch.ops import cuda_kernels as ck

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["mlmc_tpu"] = None
import numpy as np
import mlmc_tpu_torch as mt
from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates
accs = mt.synth_mlmc_pipeline(1, 6, [2000, 500], [0.5, 0.25], domain=(-4, 4))
est = accumulators_to_estimates(accs)
assert est["mean"][0] == 1.0
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m in ("jax", "mlmc_tpu") or m.startswith(("jax.", "mlmc_tpu.")))]
assert not loaded, loaded
print("isolated-ok")
"""


def test_import_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "isolated-ok" in proc.stdout


def test_no_jax_imports_in_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|mlmc_tpu)\b", re.M)
    files = sorted((REPO / "mlmc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("call", ["rng", "noise", "normals"])
def test_cuda_request_without_gpu_raises(call):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the kernel runs instead")
    before = ck.launch_counts()
    with pytest.raises(RuntimeError, match="is_available"):
        if call == "rng":
            ck.synth_mlmc_pipeline(0, 5, (100,), (0.5,), domain=(-4, 4),
                                   device="cuda")
        elif call == "noise":
            ck.synth_moment_pipeline_from_noise(
                np.zeros(64, np.float32), 5, fine_step=0.5, coarse_step=0.25,
                domain=(-4, 4), device="cuda")
        else:
            ck.synth_normals(0, 64, device="cuda")
    assert ck.launch_counts() == before
