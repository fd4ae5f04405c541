"""Fixtures of the benchmark's own tests: the import path, a data root of
tiny cells on the CPU, and the card (tests that need one skip here)."""
import json
import os
import shutil
import sys

import pytest

CODE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(CODE)
for path in (CODE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

#: each cell cut to a size that a CPU test holds: the same job kinds and
#: configurations, a few thousand samples, coarser Darcy grids
TINY = {
    "synth5.headline": dict(n_per_level=[4000, 2000, 1000, 500, 200], check_share=0.5),
    "darcy2d.adaptive": dict(initial_n=[200, 50, 20], target_var=1e-4,
                             pool={"min_bucket": 64, "max_batch": 256}, check_share=0.5),
    "synth5.adaptive": dict(initial_n=[4000, 100], target_var=2e-5,
                            pool={"min_bucket": 1024, "max_batch": 4096}, check_share=0.5),
    "synth5.process": dict(n_per_level=[20000, 8000, 3000, 1000, 300],
                           pool={"min_bucket": 1024, "max_batch": 8192}, check_share=0.5,
                           trace_jobs=2),
}
TINY_CONFIGS = {"darcy2d": {"levels": {"steps": [0.25, 0.125, 0.0625]}}}


def make_root(directory, cells=TINY, data="bench"):
    """A data root like the checkout's: BENCHMARK.json, the configurations
    and the cell files, with the sizes of ``cells`` and ``TINY_CONFIGS``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["paths"] = [data]
    os.makedirs(os.path.join(directory, data, "configs"), exist_ok=True)
    os.makedirs(os.path.join(directory, data, "workloads"), exist_ok=True)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(TINY_CONFIGS.get(c["name"], {}))
        c["file"] = "%s/configs/%s.json" % (data, c["name"])
        with open(os.path.join(directory, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name, changes in cells.items():
        with open(os.path.join(CODE, "workloads", name + ".json")) as f:
            cell = json.load(f)
        cell.update(warm_jobs=1, **changes)
        with open(os.path.join(directory, data, "workloads", name + ".json"), "w") as f:
            json.dump(cell, f)
    with open(os.path.join(directory, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return directory


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("portbench_root")))


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with the command in portbench/README.md")
    return torch.device("cuda", 0)
