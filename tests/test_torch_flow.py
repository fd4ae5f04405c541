"""Mesh I/O and the external-binary simulations of mlmc_tpu_torch against
mlmc_tpu's: ``tool/gmsh_io``, the native gmsh parser and ``$ElementData``
writer (``native/gmsh_fast.cpp``), ``tool/flow_utils``,
``sim/external.ExternalCommandSimulation`` and ``sim/flow_sim.FlowSim``.

Files written by one package are read by the other: the ASCII and binary
meshes and the fields files byte for byte, the parsed meshes equal (the
native parser's element centers within 1e-15 of the Python reader's). The
simulations run with mock binaries (a mock gmsh that writes a canned msh2
square, a mock flow123d whose flux is minus the mean of the conductivity
it is given; both plain Python with no imports beyond the standard
library, so a solver run costs a Python start) through ``OneProcessPool``,
4 + 2 samples; ``ExternalCommandSimulation`` gives the values mlmc_tpu's
gives for the same (step, seed).
"""
import os
import sys

import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import native
from mlmc_tpu_torch.sim.flow_sim import FlowSim
from mlmc_tpu_torch.tool.gmsh_io import GmshIO

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

MOCK_GMSH = '''#!/usr/bin/env python3
"""Mock gmsh: writes a canned msh2 square; finer clscale => more triangles."""
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
cl = float(args[args.index("-clscale") + 1])
header = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
2
2 1 "ground"
1 2 ".bc_outflow"
$EndPhysicalNames
"""
if cl <= 0.3:  # fine: 4 triangles around the center node
    body = """$Nodes
5
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
5 0.5 0.5 0
$EndNodes
$Elements
5
1 2 2 1 1 1 2 5
2 2 2 1 1 2 3 5
3 2 2 1 1 3 4 5
4 2 2 1 1 4 1 5
5 1 2 2 2 2 3
$EndElements
"""
else:  # coarse: 2 triangles
    body = """$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
3
1 2 2 1 1 1 2 3
2 2 2 1 1 1 3 4
3 1 2 2 2 2 3
$EndElements
"""
open(out, "w").write(header + body)
'''

MOCK_FLOW123D = '''#!/usr/bin/env python3
"""Mock flow123d: flux := -mean(conductivity) of the fields file; fails if
the rendered YAML still contains placeholders."""
import os, sys
args = sys.argv[1:]
indir = args[args.index("-i") + 1]
outdir = args[args.index("-o") + 1]
text = open(args[args.index("-s") + 1]).read()
assert "<mesh_file>" not in text and "<conductivity>" not in text, text
lines = iter(open(os.path.join(indir, "fields_sample.msh")).read().split("\\n"))
for line in lines:
    if line.strip() == "$ElementData":
        break
strings = [next(lines) for _ in range(int(next(lines)))]
reals = [next(lines) for _ in range(int(next(lines)))]
ints = [int(next(lines)) for _ in range(int(next(lines)))]
values = [float(next(lines).split()[1]) for _ in range(ints[2])]
flux = -sum(values) / len(values)
with open(os.path.join(outdir, "water_balance.yaml"), "w") as f:
    f.write("data:\\n- {time: 0, region: .bc_outflow, data: [%r, 0.0]}\\n" % flux)
'''

MESH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
2
2 7 "bulk"
1 9 ".bc"
$EndPhysicalNames
$Nodes
4
1 0 0 0
2 2 0 0
3 2 2 0
4 0 2 0
$EndNodes
$Elements
3
1 2 2 7 1 1 2 3
2 2 2 7 1 1 3 4
3 1 2 9 2 2 3
$EndElements
"""


def _write_executable(path, text):
    path.write_text(text)
    os.chmod(path, 0o755)
    return str(path)


def _grid_mesh(path, n=12, seed=0):
    """An n x n square of 2 n^2 triangles with jittered inner nodes, a bulk
    region and a boundary region, written by this package's GmshIO."""
    rng = np.random.default_rng(seed)
    mesh = GmshIO()
    x = np.linspace(0.0, 1.0, n + 1)
    nid = {}
    for i, xi in enumerate(x):
        for j, yj in enumerate(x):
            inner = 0 < i < n and 0 < j < n
            jitter = rng.uniform(-0.2, 0.2, 2) / n if inner else (0.0, 0.0)
            nid[i, j] = len(nid) + 1
            mesh.nodes[nid[i, j]] = (xi + jitter[0], yj + jitter[1], 0.5)
    eid = 1
    for i in range(n):
        for j in range(n):
            a, b, c, d = nid[i, j], nid[i + 1, j], nid[i + 1, j + 1], nid[i, j + 1]
            for tri in ((a, b, c), (a, c, d)):
                mesh.elements[eid] = (2, [3, 1], list(tri))
                eid += 1
    for j in range(n):
        mesh.elements[eid] = (1, [4, 2], [nid[n, j], nid[n, j + 1]])
        eid += 1
    mesh.physical = {"bulk": (3, 2), ".bc_outflow": (4, 1)}
    mesh.write_ascii(str(path))
    return mesh


def test_gmsh_io_files_read_and_written_as_mlmc_tpu(tmp_path):
    from mlmc_tpu.tool.gmsh_io import GmshIO as JGmshIO

    src = tmp_path / "m.msh"
    _grid_mesh(src, n=6)
    ours, theirs = GmshIO(str(src)), JGmshIO(str(src))
    assert ours.nodes == theirs.nodes and ours.elements == theirs.elements
    assert ours.physical == theirs.physical
    for name, obj in (("a", ours), ("b", theirs)):
        obj.write_ascii(str(tmp_path / ("%s.msh" % name)))
        obj.write_binary(str(tmp_path / ("%s.bin.msh" % name)))
    assert (tmp_path / "a.msh").read_bytes() == (tmp_path / "b.msh").read_bytes()
    assert (tmp_path / "a.bin.msh").read_bytes() == (tmp_path / "b.bin.msh").read_bytes()
    ele_ids = sorted(e for e, (t, _, _) in ours.elements.items() if t == 2)
    values = np.random.default_rng(1).lognormal(size=(len(ele_ids), 1))
    ours.write_fields(str(tmp_path / "fa.msh"), ele_ids, {"conductivity": torch.tensor(values)})
    theirs.write_fields(str(tmp_path / "fb.msh"), ele_ids, {"conductivity": values})
    assert (tmp_path / "fa.msh").read_bytes() == (tmp_path / "fb.msh").read_bytes()
    back = JGmshIO(str(tmp_path / "fa.msh")).read_element_data()["conductivity"][0.0]
    assert [back[e][0] for e in ele_ids] == list(values[:, 0])
    with open(tmp_path / "fa.msh") as f:
        for line in f:
            if line.strip() == "$ElementData":
                break
        head = GmshIO().read_element_data_head(f)
    assert head == ("conductivity", 0.0, 0, 1, len(ele_ids))


def test_gmsh_v1_files_read_as_mlmc_tpu(tmp_path):
    from mlmc_tpu.tool.gmsh_io import GmshIO as JGmshIO

    v1 = tmp_path / "v1.msh"
    v1.write_text("$NOD\n3\n1 0 0 0\n2 1 0 0\n3 0 1 0\n$ENDNOD\n"
                  "$ELM\n1\n1 2 5 5 3 1 2 3\n$ENDELM\n")
    ours, theirs = GmshIO(str(v1)), JGmshIO(str(v1))
    assert ours.nodes == theirs.nodes and ours.elements == theirs.elements
    assert ours.elements[1] == (2, [5, 5], [1, 2, 3])
    assert native.parse_gmsh_mesh(str(v1)) is None    # the Python reader's format


def _python_extract(path):
    """Bulk elements of a mesh by mlmc_tpu's Python reader."""
    from mlmc_tpu.tool.gmsh_io import GmshIO as JGmshIO

    mesh = JGmshIO(str(path))
    bc = {rid for name, (rid, _) in mesh.physical.items() if name.startswith(".")}
    rows = [(e, tags[0], np.mean([mesh.nodes[n] for n in nodes], axis=0))
            for e, (_, tags, nodes) in mesh.elements.items() if tags[0] not in bc]
    return (np.array([r[0] for r in rows]), np.array([r[1] for r in rows]),
            np.array([r[2] for r in rows]),
            {name: rid for name, (rid, _) in mesh.physical.items()})


def test_native_parser_matches_the_python_reader(tmp_path):
    if not native.gmsh_available():
        pytest.skip("no C++ compiler: %s" % native.gmsh_build_error())
    path = tmp_path / "grid.msh"
    _grid_mesh(path, n=12, seed=3)
    parsed = native.parse_gmsh_mesh(str(path))
    ele_ids, regions, centers, region_map = _python_extract(path)
    np.testing.assert_array_equal(parsed["ele_ids"], ele_ids)
    np.testing.assert_array_equal(parsed["region_ids"], regions)
    np.testing.assert_allclose(parsed["centers"], centers, rtol=1e-15, atol=1e-15)
    assert parsed["region_map"] == region_map and len(ele_ids) == 2 * 12 * 12
    lib = native.library_path(native.GMSH_SOURCE)
    assert lib.parent.name == "_build" and lib.name.startswith("libgmsh_fast_")
    assert "jax" not in native.GMSH_SOURCE.read_text()
    assert native.parse_gmsh_mesh(str(tmp_path / "missing.msh")) is None


def test_native_fields_writer_is_read_by_both_packages(tmp_path):
    from mlmc_tpu.tool.gmsh_io import GmshIO as JGmshIO

    if not native.gmsh_available():
        pytest.skip("no C++ compiler: %s" % native.gmsh_build_error())
    ele_ids = np.arange(3, 40, dtype=np.int64)
    rng = np.random.default_rng(2)
    fields = {"conductivity": rng.lognormal(size=len(ele_ids)),
              "porosity": rng.uniform(size=(len(ele_ids), 2))}
    path = str(tmp_path / "fields.msh")
    assert native.write_gmsh_fields(path, ele_ids, fields)
    for reader in (GmshIO, JGmshIO):
        data = reader(path).read_element_data()
        assert [data["conductivity"][0.0][e][0] for e in ele_ids] == \
            list(fields["conductivity"])
        np.testing.assert_array_equal(
            np.array([data["porosity"][0.0][e] for e in ele_ids]), fields["porosity"])
    with pytest.raises(ValueError, match="one row"):
        native.write_gmsh_fields(path, ele_ids[:3], fields)


def test_extract_mesh_native_and_python_paths_agree(tmp_path, monkeypatch):
    msh = tmp_path / "m.msh"
    msh.write_text(MESH)
    before = dict(FlowSim.parsers)
    data = FlowSim.extract_mesh(str(msh))
    expect = "native" if native.gmsh_available() else "python"
    assert FlowSim.parsers[expect] == before[expect] + 1
    assert FlowSim.extract_mesh(str(msh)) is data          # cached
    assert data["points"].shape == (2, 2) and list(data["ele_ids"]) == [1, 2]
    assert list(data["point_region_ids"]) == [7, 7]
    assert data["region_map"] == {"bulk": 7, ".bc": 9} and data["keep_axes"] == (0, 1)
    np.testing.assert_allclose(data["points"][0], [4 / 3, 2 / 3])
    grid = tmp_path / "grid.msh"
    _grid_mesh(grid, n=5)
    fast = FlowSim.extract_mesh(str(grid))
    monkeypatch.setattr(native, "parse_gmsh_mesh", lambda path: None)
    monkeypatch.setattr(FlowSim, "_MESH_CACHE", {})
    slow = FlowSim.extract_mesh(str(grid))
    assert FlowSim.parsers["python"] >= 1
    for key in ("points", "point_region_ids", "ele_ids"):
        np.testing.assert_allclose(fast[key], slow[key], rtol=1e-15, atol=1e-15)
    assert fast["region_map"] == slow["region_map"] and fast["keep_axes"] == (0, 1)
    one = FlowSim.extract_mesh(str(grid), keep_axes=(0, 1, 2))
    assert one["points"].shape[1] == 3


def _flow_sim(tmp_path):
    gmsh = _write_executable(tmp_path / "mock_gmsh", MOCK_GMSH)
    flow = _write_executable(tmp_path / "mock_flow123d", MOCK_FLOW123D)
    geo = tmp_path / "square.geo"
    geo.write_text("// geometry consumed by the mock\n")
    tmpl = tmp_path / "flow_input.yaml.tmpl"
    tmpl.write_text("mesh: <mesh_file>\ndt: <timestep_h1>\ncond: <conductivity>\n")
    return FlowSim(dict(
        env={"gmsh": gmsh, "flow123d": flow, "gmsh_version": 2},
        fields_params=dict(model="fourier", corr_length=0.5, dim=2, log=True, sigma=1,
                           mode_no=64),
        yaml_file=str(tmpl), geo_file=str(geo), work_dir=str(tmp_path / "work")),
        clean=True)


def test_flow_sim_with_mock_binaries(tmp_path, monkeypatch):
    """Per-level mesh build, template rendering, the joint fine/coarse field
    draw, the solver, the flux: a 2-level run of 4 + 2 samples through
    OneProcessPool on the CPU; a renewed sample replays bit for bit."""
    monkeypatch.chdir(tmp_path)          # workspace samples change directory
    sim = _flow_sim(tmp_path)
    storage = mt.Memory()
    pool = mt.OneProcessPool(work_dir=str(tmp_path / "out"), device="cpu")
    sampler = mt.Sampler(storage, pool, sim, [[0.6], [0.2]])
    sampler.set_initial_n_samples([4, 2])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples(sleep=0.01)
    assert list(storage.get_n_collected()) == [4, 2]
    assert not any(len(v) for v in storage.failed_samples().values())
    pairs = storage.sample_pairs()
    assert np.all(np.asarray(pairs[0])[..., 0] > 0) and np.all(np.asarray(pairs[1]) > 0)
    fine, coarse = np.asarray(pairs[1])[0, :, 0], np.asarray(pairs[1])[0, :, 1]
    assert not np.allclose(fine, coarse)
    cfg = sampler._level_sim_objects[1].config_dict
    text = open(os.path.join(cfg["fine"]["common_files_dir"], FlowSim.YAML_FILE)).read()
    assert "fields_sample.msh" in text and "dt: 0.2" in text
    r1 = FlowSim.calculate(cfg, seed=123, device="cpu")
    r2 = FlowSim.calculate(cfg, seed=123, device="cpu")
    assert np.array_equal(r1[0], r2[0]) and np.array_equal(r1[1], r2[1])
    # the flux is what the mock computes from the field drawn for the seed
    meshes = [FlowSim.extract_mesh(os.path.join(cfg[k]["common_files_dir"], FlowSim.MESH_FILE))
              for k in ("fine", "coarse")]
    f_fields, c_fields = FlowSim._draw_fields(cfg, 123, meshes[0], meshes[1], device="cpu")
    np.testing.assert_allclose(r1[0], [np.mean(f_fields["conductivity"])], rtol=1e-15)
    np.testing.assert_allclose(r1[1], [np.mean(c_fields["conductivity"])], rtol=1e-15)
    assert f_fields["conductivity"].shape == (4, 1) and c_fields["conductivity"].shape == (2, 1)
    assert sim.result_format()[0].name == "conductivity"
    assert sim.n_ops_estimate(0.5) == pytest.approx(4 * np.log(2))


def _external(cls, spec, template):
    def extract(output_file, config):
        with open(output_file) as f:
            return np.array([float(f.read().strip())])

    solver = ("import sys\n"
              "lines = open(sys.argv[1]).read().split()\n"
              "step = float(lines[0].split('=')[1]); seed = int(lines[1].split('=')[1])\n"
              "import random; random.seed(seed)\n"
              "open(sys.argv[2], 'w').write(repr(random.gauss(0, 1) + step))\n")
    return cls(dict(command=[sys.executable, "-c", solver, "{input_file}", "{output_file}"],
                    template_file=str(template), extract_result=extract,
                    result_format=[spec(name="val", unit="", shape=(1,), times=[0],
                                        locations=["0"])]))


def test_external_command_simulation_as_mlmc_tpu(tmp_path):
    from mlmc_tpu.quantity.quantity_spec import QuantitySpec as JSpec
    from mlmc_tpu.sim.external import ExternalCommandSimulation as JExt
    from mlmc_tpu_torch.sim.external import ExternalCommandSimulation as TExt

    template = tmp_path / "input.tmpl"
    template.write_text("step={step}\nseed={seed}\n")
    ours = _external(TExt, mt.QuantitySpec, template)
    theirs = _external(JExt, JSpec, template)
    storage = mt.Memory()
    sampler = mt.Sampler(storage, mt.OneProcessPool(device="cpu"), ours, [[0.5], [0.125]])
    sampler.set_initial_n_samples([3, 2])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples(sleep=0.01)
    assert storage.get_n_collected() == [3, 2]
    diff = np.asarray(storage.sample_pairs()[1])[0, :, 0] - \
        np.asarray(storage.sample_pairs()[1])[0, :, 1]
    np.testing.assert_allclose(diff, 0.125 - 0.5, atol=1e-12)
    cfg_t = ours.level_instance([0.125], [0.5]).config_dict
    cfg_j = theirs.level_instance([0.125], [0.5]).config_dict
    for seed in (7, 8):
        for a, b in zip(TExt.calculate(cfg_t, seed), JExt.calculate(cfg_j, seed)):
            np.testing.assert_array_equal(a, b)
    assert not TExt.has_batch_path() and ours.n_ops_estimate(0.25) == 4.0
    bad = dict(cfg_t, command=[sys.executable, "-c", "raise SystemExit(3)"])
    with pytest.raises(RuntimeError, match="rc=3"):
        TExt.calculate(bad, 1)


def test_flow_utils_as_mlmc_tpu(tmp_path):
    from mlmc_tpu.tool import flow_utils as jfu
    from mlmc_tpu_torch.tool import flow_utils as tfu

    tmpl = tmp_path / "template.yaml"
    tmpl.write_text("a: <alpha>\nb: <beta>\nc: <unused_name>\n")
    params = {"alpha": 1.5, "beta": "x", "gamma": 3}
    used = [fu.substitute_placeholders(str(tmpl), str(tmp_path / ("%s.yaml" % k)), params)
            for k, fu in (("t", tfu), ("j", jfu))]
    assert used[0] == used[1] == {"alpha", "beta"}
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    target = tmp_path / "d"
    tfu.force_mkdir(str(target))
    (target / "f").write_text("x")
    tfu.force_mkdir(str(target))
    assert (target / "f").exists()
    tfu.force_mkdir(str(target), force=True)
    assert not (target / "f").exists()
    for model in ("fourier", "exp", "TPLexp", "svd", "gauss"):
        ours = tfu.create_corr_field(model=model, mode_no=16, device="cpu")
        theirs = jfu.create_corr_field(model=model, mode_no=16)
        assert list(ours.names) == list(theirs.names) == ["conductivity"]
        a, b = ours.by_name["conductivity"].generator, theirs.by_name["conductivity"].generator
        assert type(a).__name__ == type(b).__name__
        assert a.correlation_exponent == b.correlation_exponent
