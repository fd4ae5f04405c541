"""The comparison that decides ``correct`` fails what it must.

* The control (the plain reference one step below each precision the
  configuration states, in the program's place) is judged not correct
  under each cell's limits, and the program is judged correct.
* Runs with the timed path broken underneath (the look for a card skipped,
  the rest of the run as it is) come out not correct, once for each fault
  the cell can have: half of the batch left out with the mean taken over
  the rest, an answer altered where it is produced, and for the adaptive
  runs a step that returns its state unchanged and an allocation altered. One chip, so no exchange
  between chips to leave out.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from conftest import CODE, TINY
from harness.checks import judge
from harness.manifest import Manifest
from harness.runner import Context, derive_seed, load_module, main
from harness.tracing import Tracer


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_fails_and_the_program_passes(tiny_root, cell):
    manifest = Manifest(tiny_root)
    spec = manifest.cell_file(cell)
    config = manifest.config(manifest.cell(cell)["config"])
    device = torch.device("cpu")
    kind = load_module(os.path.join(CODE, "jobs", spec["job"] + ".py"), "kind_" + spec["job"])
    ctx = Context(torch, device, config, spec, Tracer(torch, device, False), 3000000077)
    job = kind.Job(ctx)
    rec = job.run(derive_seed(3000000077, 0, 0), True)
    if hasattr(job, "capture"):
        job.capture(rec)
    assert judge(kind.check(ctx, [rec], control=False), spec["limits"])[0]
    assert not judge(kind.check(ctx, [rec], control=True), spec["limits"])[0]


def test_the_control_script(tiny_root):
    """``control.py`` prints, per seed, the program's numbers and the
    control's; under the cell's limits the first pass and the second fail."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, os.path.join(CODE, "control.py"), "--workload",
                          "synth5.headline", "--seeds", "5", "6", "--root", tiny_root,
                          "--cpu-rehearsal"], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    limits = Manifest(tiny_root).cell_file("synth5.headline")["limits"]
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [line["seed"] for line in lines] == [5, 6]
    for line in lines:
        assert judge(line["program"], limits)[0] and not judge(line["control"], limits)[0]


def _run(root, cell):
    """The run's result line; a run that ends in an exception (the warm-up
    jobs of its set-up meet the fault first) prints none, which the check
    of a benchmark counts as not correct."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            main(["--workload", cell, "--seed", "3000000099", "--seconds", "0.2",
                  "--trace", "0", "--root", root, "--cpu-rehearsal"])
    except Exception as exc:
        return {"correct": False, "crashed": repr(exc)}
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _half_of_each_level(monkeypatch):
    import mlmc_tpu_torch as mt

    real = mt.synth_mlmc_pipeline

    def half(seed, n_moments, n_per_level, *a, **k):
        return real(seed, n_moments, [n // 2 for n in n_per_level], *a, **k)

    monkeypatch.setattr(mt, "synth_mlmc_pipeline", half)


def _headline_answer_altered(monkeypatch):
    import mlmc_tpu_torch.ops.fused_estimate as fe

    real = fe.accumulators_to_estimates

    def altered(accs):
        est = real(accs)
        est["mean"][3] += 1e-4
        return est

    monkeypatch.setattr(fe, "accumulators_to_estimates", altered)


def _half_of_each_stream(monkeypatch):
    import mlmc_tpu_torch.ops.cuda_kernels as ck
    from mlmc_tpu_torch.estimator import Estimate

    real = Estimate._packed_streams

    def half(self, moments_fn, components):
        s = real(self, moments_fn, components)
        counts = tuple(n // 2 for n in s.counts)
        return ck.SampleStreams(s.fine, s.coarse, s.offsets, counts, s.has_coarse)

    monkeypatch.setattr(Estimate, "_packed_streams", half)


def _moments_altered(monkeypatch):
    from mlmc_tpu_torch.estimator import Estimate

    for name in ("estimate_moments_fast", "estimate_moments_extended"):
        real = getattr(Estimate, name)

        def altered(self, *a, _real=real, **k):
            mean, var = _real(self, *a, **k)
            mean = np.array(mean, copy=True)
            mean[..., 2] += 1e-3
            return mean, var

        monkeypatch.setattr(Estimate, name, altered)


def _allocation_altered(monkeypatch):
    """The allocation asks for twice as many samples on every level: the run
    still meets its target, so only the check of the allocation sees it."""
    import mlmc_tpu_torch as mt

    real = mt.estimate_n_samples_for_target_variance

    def altered(*a, **k):
        return real(*a, **k) * 2

    monkeypatch.setattr(mt, "estimate_n_samples_for_target_variance", altered)


def _step_unchanged(monkeypatch):
    from mlmc_tpu_torch.sampler import Sampler

    monkeypatch.setattr(Sampler, "process_adding_samples", lambda self, *a, **k: False)


FAULTS = [("synth5.headline", _half_of_each_level), ("synth5.headline", _headline_answer_altered)]
for _cell in ("darcy2d.adaptive", "synth5.adaptive"):
    FAULTS += [(_cell, _half_of_each_stream), (_cell, _moments_altered), (_cell, _step_unchanged),
               (_cell, _allocation_altered)]
FAULTS += [("synth5.process", _half_of_each_stream), ("synth5.process", _moments_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=["%s-%s" % (c, f.__name__.strip("_"))
                                                     for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    assert _run(tiny_root, cell)["correct"]
    fault(monkeypatch)
    assert not _run(tiny_root, cell)["correct"]
