"""Each job kind rehearsed end to end at tiny sizes on the CPU (the
kernels' plain versions), in a process of its own, as the card runs it."""
import json
import os
import subprocess
import sys

import pytest

from conftest import CODE, TINY, make_root


def rehearse(root, cell, *extra, seconds="0.3", trace="0"):
    out = subprocess.run(
        [sys.executable, os.path.join(CODE, "run.py"), "--workload", cell, "--seed",
         "3000000123", "--seconds", seconds, "--trace", trace, "--root", root,
         "--cpu-rehearsal", *extra],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", ["0", "1"])
def test_rehearsal_runs_and_is_correct(tiny_root, cell, trace):
    result, err = rehearse(tiny_root, cell, trace=trace)
    assert result["correct"], err[-2000:]
    assert result["device"]["platform"] == "cpu" and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    sources = {m["name"]: m["source"] for m in bench["end_to_end"] + bench["per_layer"]}
    # a CPU run carries no device metric
    assert all(sources[name] != "device_trace" for name in result["metrics"])
    if trace == "0":
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2


def test_a_cell_defined_only_in_a_data_directory(tmp_path):
    """A cell that exists only as data (its entry in BENCHMARK.json and its
    cell file) is found and run by the harness, with no code of its own."""
    root = make_root(str(tmp_path), cells={})
    with open(os.path.join(CODE, "workloads", "synth5.headline.json")) as f:
        small = {**json.load(f), "n_per_level": [3000, 1000, 500, 100, 50],
                 "warm_jobs": 1, "check_share": 1.0}
    with open(os.path.join(root, "bench", "workloads", "synth5.small.json"), "w") as f:
        json.dump(small, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "synth5.small", "config": "synth5",
                               "traffic": "headline", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "synth5.headline" in m["workloads"]:
            m["workloads"].append("synth5.small")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    result, _ = rehearse(root, "synth5.small")
    assert result["correct"] and set(result["metrics"]) == {
        "setup_s", "samples_per_s", "job_p95_ms"}


def test_no_jax_and_no_reference_package_after_a_rehearsal(tiny_root):
    """The run's own process, after its window: no module whose top-level
    name is jax, jaxlib, flax or mlmc_tpu (mlmc_tpu_torch is the program)."""
    script = (
        "import sys, runpy; sys.argv = %r; sys.path[:0] = [%r]\n"
        "from harness.runner import main\n"
        "main(sys.argv[1:])\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print('TOP', sorted(top & {'jax', 'jaxlib', 'flax', 'mlmc_tpu', 'mlmc_tpu_torch'}))\n"
        % (["run.py", "--workload", "synth5.process", "--seed", "5", "--seconds", "0.2",
            "--trace", "0", "--root", tiny_root, "--cpu-rehearsal"], CODE))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=os.path.dirname(CODE))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "TOP ['mlmc_tpu_torch']"


def test_a_run_without_the_program_exits_without_a_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    run fails and prints no result line."""
    copy = tmp_path / "bare"
    copy.mkdir()
    subprocess.run(["cp", "-r", CODE, str(copy / "portbench")], check=True)
    subprocess.run(["cp", os.path.join(os.path.dirname(CODE), "BENCHMARK.json"), str(copy)],
                   check=True)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "synth5.headline",
                          "--seed", "1", "--seconds", "1", "--trace", "0", "--cpu-rehearsal"],
                         capture_output=True, text=True, timeout=300, cwd=str(copy),
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_a_run_needs_the_card(tmp_path):
    """Without --cpu-rehearsal a machine with no CUDA device gets no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(CODE, "run.py"), "--workload",
                          "synth5.headline", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
