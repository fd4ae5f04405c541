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


def test_two_process_gloo_world(tmp_path):
    import torch_mesh_worker as worker

    ctx = multiprocessing.get_context("spawn")
    init_file = str(tmp_path / "store")
    procs = [ctx.Process(target=worker.rank_main,
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
    ranks = [dict(np.load(tmp_path / ("rank%d.npz" % r))) for r in range(2)]
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
