"""The file-backed storages of mlmc_tpu_torch against mlmc_tpu's.

The same inputs, made from a seed with numpy, go through both packages:

* a file written by one package is compared with the other's dataset by
  dataset and attribute by attribute, dtypes included (HDF5), or byte for
  byte (the binary log, its id sidecars and its JSON metadata), and is read
  back through the other package's storage (bit for bit: both store f64);
* reopen-and-append, the result-format guard, rows past ``len(ids)``
  dropped, zero-collected and all-failed levels, level-id gaps;
* ``Estimate`` over a file storage against ``Estimate`` over ``Memory`` on
  the same samples: generic tier 1e-10 relative, fast tier within
  ``ops/precision.py``'s f32 bound, f64 tier 1e-10.
"""
import json
import os

import numpy as np
import pytest
import torch

import mlmc_tpu
import mlmc_tpu_torch as mt
from mlmc_tpu_torch import native
from mlmc_tpu_torch.ops.precision import C_BOUND, EPS32

torch.set_num_threads(1)

LEVELS = [[0.1], [0.01], [0.001]]
M = 24
KINDS = ["hdf", "bin"]


def _need(kind):
    if kind == "hdf":
        pytest.importorskip("h5py")
    elif not native.available():
        pytest.skip("no C++ compiler: %s" % native.build_error())
    elif mlmc_tpu.SampleStorageBin is None or not mlmc_tpu.native.available():
        pytest.skip("mlmc_tpu's native engine is unavailable")


def _make(pkg, kind, path, **kw):
    if kind == "hdf":
        return pkg.SampleStorageHDF(file_path=str(path) + ".hdf5")
    return pkg.SampleStorageBin(dir_path=str(path), **kw)


def _tags(level, idx):
    return ["L{:02d}_S{:07d}".format(level, i) for i in idx]


def _fill(storage, pkg, seed=0):
    """One run's worth of calls, the same for either package."""
    rng = np.random.default_rng(seed)
    storage.save_global_data(result_format=pkg.SynthSimulation().result_format(),
                             level_parameters=LEVELS)
    for level, n in ((0, 12), (1, 6), (2, 4)):
        storage.save_scheduled_samples(level, _tags(level, range(n)))
    fine, coarse = rng.normal(size=(2, 9, M))
    tupled = {0: [(t, (fine[i], np.zeros(M))) for i, t in enumerate(_tags(0, range(6)))],
              1: [(t, (fine[6 + i], coarse[6 + i])) for i, t in enumerate(_tags(1, range(3)))]}
    storage.save_samples(tupled, {0: [("L00_S0000006", "result is nan")], 1: []})
    # the bulk path: 4 ids, 7 rows; rows past the ids are not samples
    bulk_f, bulk_c = rng.normal(size=(2, 7, M)).astype(np.float32)
    storage.save_samples_bulk(0, _tags(0, range(7, 11)), bulk_f,
                              np.zeros_like(bulk_c))
    storage.save_n_ops([(0, [1.5, 7]), (1, [2.5, 3]), (2, [0.0, 0])])
    return storage


def _snapshot(storage):
    """Everything a storage answers, as plain data."""
    pairs = storage.sample_pairs()
    return dict(
        n_finished=np.asarray(storage.n_finished()).tolist(),
        n_collected=[int(n) for n in storage.get_n_collected()],
        n_levels=storage.get_n_levels(),
        level_ids=list(storage.get_level_ids()),
        unfinished=sorted(storage.unfinished_ids()),
        failed={str(k): sorted(v) for k, v in storage.failed_samples().items() if len(v)},
        n_ops=[float(c) for c in storage.get_n_ops()],
        params=np.asarray(storage.get_level_parameters()).tolist(),
        scheduled={int(k): [str(t) for t in v]
                   for k, v in storage.load_scheduled_samples().items()},
        fmt=[(q.name, q.unit, tuple(q.shape), list(q.times), list(q.locations))
             for q in storage.load_result_format()],
        pairs=[None if p is None or np.size(p) == 0 else np.asarray(p)
               for p in pairs],
        chunks=[(c.level_id, c.chunk_id, c.chunk_slice.start, c.chunk_slice.stop)
                for c in storage.chunks()],
    )


def _assert_same_answers(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if key == "pairs":
            assert len(a[key]) == len(b[key])
            for x, y in zip(a[key], b[key]):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype == np.float64
                    np.testing.assert_array_equal(x, y)
        else:
            assert a[key] == b[key], key


def _hdf_tree(path):
    """{object name: (attrs, dtype, shape, maxshape, chunks, values)}."""
    import h5py

    tree = {}

    def attrs(obj):
        return {k: (np.asarray(v).dtype.str, np.asarray(v).tolist())
                for k, v in obj.attrs.items()}

    with h5py.File(path, "r") as f:
        tree["/"] = (attrs(f),)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                tree[name] = (attrs(obj), obj.dtype, obj.shape, obj.maxshape,
                              obj.chunks, obj[()])
            else:
                tree[name] = (attrs(obj),)

        f.visititems(visit)
    return tree


def _assert_same_tree(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name][0] == b[name][0], name             # attrs, with dtypes
        if len(a[name]) > 1:
            assert a[name][1:5] == b[name][1:5], name      # dtype ... chunks
            np.testing.assert_array_equal(a[name][5], b[name][5])


# --------------------------------------------------------------------- #
# (i) files of one package in the other
# --------------------------------------------------------------------- #
def test_hdf_files_are_the_same_dataset_by_dataset(tmp_path):
    _need("hdf")
    for pkg, name in ((mlmc_tpu, "jax"), (mt, "torch")):
        _fill(_make(pkg, "hdf", tmp_path / name), pkg).close()
    tree_j = _hdf_tree(str(tmp_path / "jax.hdf5"))
    tree_t = _hdf_tree(str(tmp_path / "torch.hdf5"))
    assert tree_t["/"][0]["version"][1] == "1.0.1"
    assert tree_t["Levels/0/collected_values"][1:4] == (
        np.dtype("<f8"), (10, 2, M), (None, 2, M))
    assert tree_t["Levels/0/scheduled"][1] == np.dtype([("sample_id", "S100")])
    assert tree_t["Levels/0/failed"][1] == np.dtype(
        [("sample_id", "S100"), ("message", "S1000")])
    assert "Levels/2/collected_values" not in tree_t
    _assert_same_tree(tree_j, tree_t)


def test_bin_files_are_the_same_byte_for_byte(tmp_path):
    _need("bin")
    for pkg, name in ((mlmc_tpu, "jax"), (mt, "torch")):
        _fill(_make(pkg, "bin", tmp_path / name), pkg).close()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert names == ["level_0.bin", "level_0.ids", "level_1.bin",
                     "level_1.ids", "meta.json"]
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "torch" / name).read_bytes(), name
    header = (tmp_path / "torch" / "level_0.bin").read_bytes()[:16]
    assert header[:8] == b"MLMC_BIN"[::-1]       # the magic, little endian
    assert np.frombuffer(header[8:], "<u4").tolist() == [1, M]
    assert os.path.getsize(tmp_path / "torch" / "level_0.bin") == 16 + 10 * 2 * M * 8
    assert json.loads((tmp_path / "torch" / "meta.json").read_text())["m"] == M


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_file_of_one_package_opens_in_the_other(tmp_path, kind, writer, reader):
    _need(kind)
    pkgs = {"jax": mlmc_tpu, "torch": mt}
    written = _fill(_make(pkgs[writer], kind, tmp_path / "run"), pkgs[writer])
    own = _snapshot(written)
    written.close()
    other = _make(pkgs[reader], kind, tmp_path / "run")
    _assert_same_answers(own, _snapshot(other))
    assert own["n_collected"] == [10, 3, 0] and own["n_finished"] == [11, 3, 0]
    assert own["unfinished"] == ["L00_S0000011", "L01_S0000003", "L01_S0000004",
                                 "L01_S0000005"] + _tags(2, range(4))
    assert own["pairs"][0].shape == (M, 10, 1) and own["pairs"][1].shape == (M, 3, 2)
    # the other package goes on where the first stopped
    rng = np.random.default_rng(9)
    other.save_samples_bulk(1, _tags(1, range(3, 6)), *rng.normal(size=(2, 3, M)))
    assert [int(n) for n in other.get_n_collected()] == [10, 6, 0]
    other.close()
    back = _make(pkgs[writer], kind, tmp_path / "run")
    assert [int(n) for n in back.get_n_collected()] == [10, 6, 0]
    np.testing.assert_array_equal(np.asarray(back.sample_pairs()[1])[:, :3],
                                  own["pairs"][1])
    back.close()


@pytest.mark.parametrize("kind", KINDS)
def test_storage_from_jax_takes_a_file_storage(tmp_path, kind):
    _need(kind)
    source = _fill(_make(mlmc_tpu, kind, tmp_path / "run"), mlmc_tpu)
    copy = mt.storage_from_jax(source)
    assert copy.get_n_collected() == [10, 3, 0]
    for a, b in zip(copy.sample_pairs()[:2], source.sample_pairs()[:2]):
        np.testing.assert_array_equal(a, np.asarray(b))
    source.close()


# --------------------------------------------------------------------- #
# (ii) the storage contract on files
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", KINDS)
def test_reopen_and_append(tmp_path, kind):
    _need(kind)
    storage = _fill(_make(mt, kind, tmp_path / "run"), mt)
    before = _snapshot(storage)
    storage.close()
    again = _make(mt, kind, tmp_path / "run")
    _assert_same_answers(before, _snapshot(again))
    # a resume saves the global data again: nothing is lost by it
    again.save_global_data(result_format=mt.SynthSimulation().result_format(),
                           level_parameters=LEVELS)
    _assert_same_answers(before, _snapshot(again))
    rng = np.random.default_rng(4)
    fine, coarse = rng.normal(size=(2, 5, M))
    again.save_scheduled_samples(2, _tags(2, range(4, 6)))
    again.save_samples_bulk(2, _tags(2, range(5)), torch.from_numpy(fine),
                            torch.from_numpy(coarse))
    again.save_samples({}, {2: [("L02_S0000005", "boom")]})
    again.save_n_ops([(2, [4.0, 5])])
    assert [int(n) for n in again.get_n_collected()] == [10, 3, 5]
    assert np.asarray(again.n_finished()).tolist() == [11, 3, 6]
    assert again.get_n_ops()[2] == 0.8
    pairs = np.asarray(again.sample_pairs()[2])
    np.testing.assert_array_equal(pairs[:, :, 0], fine.T)
    np.testing.assert_array_equal(pairs[:, :, 1], coarse.T)
    # the reader of a level that grew after it was read sees the new rows
    again.save_samples_bulk(2, _tags(2, range(6, 8)), fine[:2], coarse[:2])
    assert np.asarray(again.sample_pairs()[2]).shape == (M, 7, 2)
    assert [t for t in again.unfinished_ids() if t.startswith("L02")] == []
    again.clear_failed()
    assert not any(len(v) for v in again.failed_samples().values())
    again.close()


@pytest.mark.parametrize("kind", KINDS)
def test_result_format_guard(tmp_path, kind):
    _need(kind)
    _fill(_make(mt, kind, tmp_path / "run"), mt).close()
    again = _make(mt, kind, tmp_path / "run")
    other = [mt.QuantitySpec(name="depth", unit="m", shape=(1, 1), times=[1],
                             locations=["a"])]
    with pytest.raises(ValueError, match="result format"):
        again.save_global_data(result_format=other, level_parameters=LEVELS)
    again.close()


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_reads(tmp_path, kind):
    """Level 0 comes back as [M, n, 1], the others as [M, n, 2], chunk by
    chunk along the sample axis only."""
    _need(kind)
    storage = _make(mt, kind, tmp_path / "run",
                    **(dict(chunk_records=4) if kind == "bin" else {}))
    _fill(storage, mt)
    whole = [np.asarray(p) for p in storage.sample_pairs()[:2]]
    for level in (0, 1):
        chunks = list(storage.chunks(level_id=level))
        parts = [storage.sample_pairs_level(c) for c in chunks]
        assert all(isinstance(p, np.ndarray) and p.shape[0] == M
                   and p.shape[2] == (1 if level == 0 else 2) for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts, axis=1), whole[level])
        assert [c.chunk_id for c in chunks] == list(range(len(chunks)))
    if kind == "bin":
        assert [c.chunk_slice.stop for c in storage.chunks(level_id=0)] == [4, 8, 10]
    limited = next(storage.chunks(level_id=0, n_samples=3))
    assert storage.sample_pairs_level(limited).shape == (M, 3, 1)
    # a scheduled level with nothing collected: one empty, shaped chunk
    empty = list(storage.chunks(level_id=2))
    assert len(empty) == 1
    assert storage.sample_pairs_level(empty[0]).shape == (M, 0, 2)
    assert storage.payload_resident is False
    storage.close()


def _run(storage, pool, counts, sim=None, levels=([0.1], [0.01])):
    sim = sim or mt.SynthSimulation(dict(distr="norm", complexity=2))
    sampler = mt.Sampler(storage, pool, sim, [list(l) for l in levels])
    sampler.set_initial_n_samples(list(counts))
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    return sampler


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("device_results", [True, False])
def test_padding_rows_never_reach_the_file(tmp_path, kind, device_results):
    """50 and 30 samples in cost classes of 64: what the file holds, and
    the generic tier's means over it, equal Memory's bit for bit."""
    _need(kind)
    import mlmc_tpu_torch.quantity.quantity_estimate as qe

    res = []
    for storage in (mt.Memory(), _make(mt, kind, tmp_path / "run")):
        pool = mt.DeviceBatchPool(seed=11, min_bucket=64,
                                  device_results=device_results, device="cpu")
        sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
        _run(storage, pool, (50, 30), sim)
        assert list(storage.get_n_collected()) == [50, 30]
        root = mt.make_root_quantity(storage, sim.result_format(), device="cpu")
        mean = qe.estimate_mean(qe.moments(root["length"][1]["10"][0],
                                           mt.Legendre(4, (-4, 4))))
        res.append((np.asarray(mean.mean), list(mean.n_samples),
                    [np.asarray(p) for p in storage.sample_pairs()]))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert res[0][1] == res[1][1]
    for a, b in zip(res[0][2], res[1][2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_all_failed_and_zero_collected_levels(tmp_path, kind):
    _need(kind)

    def boom(config, seed):
        raise RuntimeError("injected failure")

    storage = _make(mt, kind, tmp_path / "run")
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    sampler = mt.Sampler(storage, mt.OneProcessPool(device="cpu"), sim, LEVELS)
    sampler._level_sim_objects[1].calculate = boom
    sampler.set_initial_n_samples([8, 4, 0])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    assert [int(n) for n in storage.get_n_collected()][:2] == [8, 0]
    assert np.asarray(storage.n_finished()).tolist()[:2] == [8, 4]
    assert sum(len(v) for v in storage.failed_samples().values()) == 4
    n_ops = storage.get_n_ops()
    assert n_ops[0] > 0 and n_ops[1] == 0.0
    assert storage.unfinished_ids() == []
    chunk = next(storage.chunks(level_id=1))
    assert storage.sample_pairs_level(chunk).shape == (M, 0, 2)
    storage.close()
    again = _make(mt, kind, tmp_path / "run")
    assert "injected failure" not in str(again.failed_samples())   # ids only
    assert sorted(again.failed_samples()["1"]) == _tags(1, range(4))
    again.close()


def test_bin_level_id_gap(tmp_path):
    """Per-level vectors are indexed by level id: results on level 2 alone
    must not shift into the slots of the empty levels 0 and 1."""
    _need("bin")
    rng = np.random.default_rng(3)
    fine, coarse = rng.normal(size=(2, 5, M))
    answers = []
    for pkg, name in ((mlmc_tpu, "jax"), (mt, "torch")):
        storage = _make(pkg, "bin", tmp_path / name)
        storage.save_global_data(result_format=pkg.SynthSimulation().result_format(),
                                 level_parameters=LEVELS)
        storage.save_samples_bulk(2, _tags(2, range(5)), fine, coarse)
        storage.save_n_ops([(2, [1.0, 5])])
        assert storage.get_level_ids() == [2]
        assert storage.get_n_collected() == [0, 0, 5]
        assert storage.get_n_ops() == [0.0, 0.0, 0.2]
        pairs = storage.sample_pairs()
        assert pairs[0] is None and pairs[1] is None
        answers.append(np.asarray(pairs[2]))
        storage.close()
    np.testing.assert_array_equal(answers[0], answers[1])


def test_bin_without_a_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", RuntimeError("no C++ compiler"))
    assert not native.available()
    with pytest.raises(RuntimeError, match="native engine unavailable .*use "
                                           "Memory or SampleStorageHDF"):
        mt.SampleStorageBin(str(tmp_path / "run"))


def test_native_library_is_built_from_the_source_by_one_compiler_call():
    _need("bin")
    path = native.library_path()
    assert path.parent.name == "_build" and path.exists()
    assert path.name.startswith("libsample_log_") and len(path.stem) == 14 + 16
    source = native.SOURCE.read_text()
    assert "jax" not in source and "gmsh" not in source


def test_sample_log_writer_and_reader(tmp_path):
    _need("bin")
    rng = np.random.default_rng(1)
    values = rng.normal(size=(37, 2, 5))
    path = str(tmp_path / "a.bin")
    for pkg_w, pkg_r in ((native, mlmc_tpu.native), (mlmc_tpu.native, native)):
        if os.path.exists(path):
            os.unlink(path)
        writer = pkg_w.SampleLogWriter(path, 5)
        assert writer.append(values[:20]) == 20 and writer.append(values[20:]) == 17
        writer.flush()
        writer.close()
        reader = pkg_r.SampleLogReader(path)
        assert reader.n_records == 37 and reader.m == 5
        np.testing.assert_array_equal(reader.read(0, 37), values)
        np.testing.assert_array_equal(reader.read(30, 100), values[30:])
        reader.close()
    with pytest.raises(IOError):
        native.SampleLogWriter(path, 6)          # another record width
    with pytest.raises(IOError):
        native.SampleLogReader(str(tmp_path / "missing.bin"))


# --------------------------------------------------------------------- #
# (iii) Estimate over a file against Estimate over Memory
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", KINDS)
def test_estimate_over_a_file_equals_estimate_over_memory(tmp_path, kind):
    _need(kind)
    mfn = mt.Legendre(6, (-5, 5))
    results = []
    for storage in (mt.Memory(), _make(
            mt, kind, tmp_path / "run",
            **(dict(chunk_records=512) if kind == "bin" else {}))):
        sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
        _run(storage, mt.DeviceBatchPool(seed=7, device="cpu"), (3000, 700, 150),
             sim, LEVELS)
        if kind == "bin" and not isinstance(storage, mt.Memory):
            storage.close()                      # estimate from a reopened run
            storage = _make(mt, kind, tmp_path / "run", chunk_records=512)
            assert len(list(storage.chunks(level_id=0))) == 6
        root = mt.make_root_quantity(storage, sim.result_format(), device="cpu")
        est = mt.Estimate(root["length"][1]["10"][0], storage, mfn)
        results.append(dict(generic=est.estimate_moments(mfn),
                            fast=est.estimate_moments_fast(),
                            f64=est.estimate_moments_extended(),
                            diff_vars=est.estimate_diff_vars(mfn),
                            diff_vars_fast=est.estimate_diff_vars_fast()))
    memory, on_file = results
    for tier, rtol, atol in (("generic", 1e-10, 1e-14), ("f64", 1e-10, 1e-14),
                             ("diff_vars", 1e-10, 1e-14),
                             # |P_k| <= 1: a level's mean of differences is a
                             # sum of absolute terms of at most 2 per sample
                             ("fast", 0.0, 2 * float(EPS32) * C_BOUND),
                             ("diff_vars_fast", 0.0, 2 * float(EPS32) * C_BOUND)):
        for got, want in zip(on_file[tier], memory[tier]):
            np.testing.assert_allclose(np.asarray(got, dtype=float),
                                       np.asarray(want, dtype=float),
                                       rtol=rtol, atol=atol, err_msg=tier)
    assert on_file["generic"][0][0] == 1.0 and on_file["fast"][0][0] == 1.0


def test_hdf_without_h5py_raises_an_import_error(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        mt.SampleStorageHDF(str(tmp_path / "x.hdf5"))
    assert not os.path.exists(tmp_path / "x.hdf5")
