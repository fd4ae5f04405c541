"""A sample mesh over several processes (``parallel/multihost``): a real
two-process ``torch.distributed`` world over gloo on the CPU, held against
a one-process run over two shards, and the single-process helpers.

Tolerance: both ranks' results equal each other bit for bit (the
all-reduce gives every rank the same sum), and equal the one-process
2-shard run with counts exact and sums within 1e-13 * S_abs (the two
shards' sums are added by the all-reduce instead of on one device); the
gathered pool payloads are bit for bit the same.
"""
import multiprocessing
import os

import numpy as np
import pytest
import torch

from mlmc_tpu_torch.parallel import SampleMesh, multihost

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _working_directory():
    """Start in a working directory that exists: a workspace test run
    earlier in this process (the pools of both packages change into sample
    directories and remove them) may have left it deleted."""
    try:
        os.getcwd()
    except FileNotFoundError:
        os.chdir(os.path.dirname(os.path.abspath(__file__)))


def _two_ranks(target, tmp_path):
    """Run ``target(rank, 2, init_file, out_path)`` in a spawned two-rank
    world; what each rank saved."""
    ctx = multiprocessing.get_context("spawn")
    init_file = str(tmp_path / "store")
    procs = [ctx.Process(target=target,
                         args=(rank, 2, init_file,
                               str(tmp_path / ("rank%d.npz" % rank))))
             for rank in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive), "a rank did not finish"
    assert [p.exitcode for p in procs] == [0, 0]
    return [dict(np.load(tmp_path / ("rank%d.npz" % r))) for r in range(2)]


def test_two_process_gloo_world(tmp_path):
    import torch_mesh_worker as worker

    ranks = _two_ranks(worker.rank_main, tmp_path)
    assert [bool(r["coordinator"]) for r in ranks] == [True, False]
    for r in ranks:
        assert int(r["n_hosts"]) == 2 and int(r["n_devices"]) == 2
        assert str(r["backend"]) == "gloo" and int(r["local_n_devices"]) == 1
    ref = worker.run_paths(SampleMesh(["cpu", "cpu"], group=False))
    for key, want in ref.items():
        a, b = ranks[0][key], ranks[1][key]
        assert np.array_equal(a, b), key
        if key.startswith("pool"):
            assert np.array_equal(a, want), key
        elif key.endswith(("n_valid", "n_total")):
            assert np.array_equal(a, want), key
        else:
            # S_abs <= 4 n for Legendre rows clipped to the domain
            n = max(worker.N_SYNTH + worker.N_FUSED)
            assert np.max(np.abs(a - want)) <= 1e-13 * 4 * n, key


def test_multihost_helpers_single_process():
    """One process: initialize is a no-op, this process coordinates, and
    the meshes span this process's devices."""
    multihost.initialize(num_processes=1)
    assert multihost.is_coordinator()
    assert multihost.n_hosts() == 1
    mesh = multihost.global_sample_mesh(["cpu"] * 8)
    assert mesh.n_devices == 8 and mesh.group is None
    assert multihost.local_sample_mesh(["cpu"] * 8).n_devices == 8
    assert mesh.pad_to_shards(13) == 16


def test_initialize_without_a_cluster_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        # the default devices are the card's: without one the mesh raises
        with pytest.raises(RuntimeError, match="is_available"):
            multihost.global_sample_mesh()
    assert os.environ.get("WORLD_SIZE") == "1"


@pytest.mark.parametrize("local_rank,per_host,want", [
    ("2", "4", [2]),            # torchrun's process of card 2 of four
    ("0", "4", [0]),
    ("0", "1", [0, 1, 2, 3]),   # one process on the host: every card, as before
    ("0", None, [0, 1, 2, 3]),  # no LOCAL_WORLD_SIZE: every card, as before
    ("7", "8", [0, 1, 2, 3]),   # names no visible card: every card, as before
    (None, None, [0, 1, 2, 3])])  # no LOCAL_RANK: every card, as before
def test_default_devices_follow_local_rank(monkeypatch, local_rank, per_host, want):
    """A process of a four-card host (device count monkeypatched, no card
    needed) under torchrun's environment takes its own card by default
    where torchrun started a process per card, and every card where it
    started one process on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    for var, value in (("LOCAL_RANK", local_rank), ("LOCAL_WORLD_SIZE", per_host)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    assert multihost._local_devices(None) == [torch.device("cuda", i) for i in want]
    assert multihost._local_devices(["cpu"]) == ["cpu"]


def test_initialize_joins_on_the_local_rank_card(monkeypatch):
    """Under torchrun's environment of a process per card, ``initialize``
    sets this process's card and joins an NCCL group of WORLD_SIZE at RANK
    (the group itself is not formed: its calls are recorded)."""
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("card", d))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    for var, value in (("WORLD_SIZE", "4"), ("RANK", "3"), ("LOCAL_RANK", "3"),
                       ("LOCAL_WORLD_SIZE", "4")):
        monkeypatch.setenv(var, value)
    multihost.initialize("host0:29500")
    assert calls.pop("card") == torch.device("cuda", 3)
    assert calls == dict(backend="nccl", init_method="tcp://host0:29500", world_size=4, rank=3)


def _portbench_reference(monkeypatch):
    """The benchmark's plain reference (``portbench/reference``: torch and
    numpy only), loaded by path."""
    import importlib
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(root, "portbench"))
    for name in [m for m in sys.modules if m == "reference" or m.startswith("reference.")]:
        monkeypatch.delitem(sys.modules, name)
    return importlib.import_module("reference.sharded"), importlib.import_module("reference.moments")


def test_the_deployment_over_two_ranks_equals_the_reference_of_its_four_ranges(
        tmp_path, monkeypatch):
    """synth5x4's path at a tiny size: two gloo ranks of two CPU shards
    each, so shard s of 4 reduces indices [s n_l / 4, (s + 1) n_l / 4) of
    each level. The all-reduced sums equal the plain reference's sums of the
    four ranges, added in shard order, within float64 rounding (S_abs <= 4 n
    for rows clipped to the domain; 1e-13 of it), and the counts exactly."""
    import torch_mesh_worker as worker

    sharded, moments = _portbench_reference(monkeypatch)
    ranks = _two_ranks(worker.deployment_rank_main, tmp_path)
    assert int(ranks[0]["n_devices"]) == 4
    per_shard = [sharded.range_level_sums(
        worker.SEED, sharded.shard_ranges(worker.DEPLOY_N, 4, s), worker.STEPS,
        worker.DEPLOY_MOMENTS, worker.DOMAIN, torch.float32, torch.float64, "cpu")
        for s in range(4)]
    want = sharded.add_shards(per_shard)
    for lvl, n in enumerate(worker.DEPLOY_N):
        assert want[lvl]["n_valid"] > 0.9 * n
        for r in ranks:
            assert int(r["%d_n_valid" % lvl]) == int(want[lvl]["n_valid"])
            for field in moments.FIELDS:
                got = r["%d_%s" % (lvl, field)]
                assert np.max(np.abs(got - want[lvl][field])) <= 1e-13 * 4 * n, (lvl, field)
