"""mlmc_tpu_torch stands alone: it imports neither jax nor mlmc_tpu, and a
CUDA request never runs on the CPU."""
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.parallel import multihost
from mlmc_tpu_torch.ops import sobol
from mlmc_tpu_torch.random import frac_geom
from mlmc_tpu_torch.sim import jumps, levy, reactions, rough, sde, spde, transport
from mlmc_tpu_torch import nested
from mlmc_tpu_torch.tool.flow_utils import create_corr_field

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib
import pkgutil
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["mlmc_tpu"] = None
sys.modules["h5py"] = None
sys.modules["yaml"] = None
sys.modules["optax"] = None
import numpy as np
import mlmc_tpu_torch as mt
for info in pkgutil.walk_packages(mt.__path__, "mlmc_tpu_torch."):
    importlib.import_module(info.name)    # every module of the package
from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates
accs = mt.synth_mlmc_pipeline(1, 6, [2000, 500], [0.5, 0.25], domain=(-4, 4),
                              device="cpu")
est = accumulators_to_estimates(accs)
assert est["mean"][0] == 1.0
sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
storage = mt.DeviceMemory(device="cpu")
sampler = mt.Sampler(storage, mt.DeviceBatchPool(seed=1, device="cpu"), sim,
                     [[0.5], [0.25]])
sampler.set_initial_n_samples([500, 100])
sampler.schedule_samples()
sampler.ask_sampling_pool_for_samples()
root = mt.make_root_quantity(storage, sim.result_format())
e = mt.Estimate(root["length"][1]["10"][0, 0], storage, mt.Legendre(5, (-4, 4)))
assert e.estimate_moments_fast()[0][0] == 1.0
assert e.estimate_moments_extended()[0][0] == 1.0
e.est_bootstrap_fast(n_subsamples=4, sample_vector=[200, 50], replace="poisson")
assert e.var_bs_mean[0] == 0.0
from mlmc_tpu_torch.parallel import SampleMesh, multihost, sharded_synth_pipeline
mesh = SampleMesh(["cpu", "cpu"], group=False)
e.est_bootstrap_fast(n_subsamples=4, sample_vector=[200, 50], replace="poisson",
                     mesh=mesh)
assert e.var_bs_mean[0] == 0.0
sharded = sharded_synth_pipeline(mesh, 6, [2000, 500], [0.5, 0.25], domain=(-4, 4))(1)
assert [int(r.n_valid) for r in sharded] == [int(a.n_valid) for a in accs]
multihost.initialize(num_processes=1)
assert multihost.is_coordinator()
fn, exact = mt.unbiased.synth_unbiased_level_fn()
u = mt.UnbiasedMLMC(fn, mt.GeometricLevels(0.4), chunk_size=64, mesh=mesh)
u.sample(64)
assert np.isfinite(u.estimates()["mean"])
import torch
gen = torch.Generator().manual_seed(0)
shoot = mt.ShootingSimulation1D(dict(
    start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
    area_borders=(-100.0, 200.0, -300.0, 400.0), max_time=10.0, complexity=5.0,
    n_modes=16, fields_params=dict(model="gauss", corr_length=1.0, sigma=0.5,
                                   log=False)))
fine, _, _ = mt.ShootingSimulation1D.calculate_batch(
    shoot.level_instance([0.1], [0.5]).config_dict, gen, 8)
assert fine.shape == (8, 1)
darcy = mt.DiffusionSimulation(dict(field_method="circulant", corr_length=0.3))
fine, _, _ = mt.DiffusionSimulation.calculate_batch(
    darcy.level_instance([1 / 8], [1 / 4]).config_dict, gen, 4)
assert fine.shape == (4, 1) and bool((fine > 0).all())
field = mt.CirculantEmbeddingField(dim=2, corr_length=0.3, grid_shape=(4, 4),
                                   grid_step=0.25, device="cpu")
assert field.sample(gen).shape == (16,)
from mlmc_tpu_torch.random import frac_geom
for cls in (mt.DiffusionSimulation3D, frac_geom.FracturedDiffusionSimulation,
            frac_geom.FracturedDiffusionSimulation3D):
    level = cls(dict(n_modes=16, n_fractures=4)).level_instance([1 / 4], [1 / 2])
    fine, _, _ = cls.calculate_batch(level.config_dict, gen, 2)
    assert fine.shape == (2, 1) and bool((fine > 0).all())
from mlmc_tpu_torch import qmc
from mlmc_tpu_torch.sim import jumps, levy, rough, sde
fns, dims = qmc.synth_qmc_level_fns([[0.5], [0.25]])
ml = mt.MLQMC(fns, dims, n_randomizations=4, chunk_size=64, point_set="lattice",
              lattice_n_max=1 << 10, device="cpu")
assert ml.run(1e-6, n_init=64)["target_met"]
lat = mt.lattice_estimate(lambda u: u.sum(dim=1), 3, n=256, n_shifts=4, device="cpu")
assert abs(lat["mean"] - 1.5) < 3 / 256       # each coordinate: within 1/n of 1/2
for cls, cfg in ((sde.SDESimulation, dict(scheme="milstein")),
                 (sde.SDESystemSimulation, dict(model="heston",
                                                payoff=lambda pf: pf.terminal[:, 0])),
                 (jumps.JumpDiffusionSimulation, {}), (levy.VarianceGammaSimulation, {}),
                 (rough.RBergomiSimulation, {})):
    level = cls(cfg).level_instance([1 / 8], [1 / 4]).config_dict
    idx = torch.arange(8)
    fine, _, _ = cls.calculate_keyed_batch(level, 1, 1, idx, torch.zeros_like(idx))
    assert fine.shape == (8, 1) and bool(torch.isfinite(fine).all())
ufn = mt.sde_unbiased_level_fn(sde.SDESimulation(dict(scheme="milstein")), n0=4)
u = mt.UnbiasedMLMC(ufn, mt.GeometricLevels(0.25), chunk_size=64, device="cpu")
u.sample(128)
assert np.isfinite(u.estimates()["mean"])
from mlmc_tpu_torch.sim import american, reactions, spde, transport
from mlmc_tpu_torch import bsde, nested, sensitivity
from mlmc_tpu_torch.random.keyed import SampleKeys
idx = torch.arange(4)
for cls, level in ((spde.SPDESimulation, spde.SPDESimulation().level_instance(
                        [1 / 8, 0.5 / 8], [1 / 4, 0.5 / 4])),
                   (reactions.ReactionSimulation,
                    reactions.ReactionSimulation().level_instance([1 / 8], [1 / 4])),
                   (transport.TransportSimulation, transport.TransportSimulation(dict(
                        field_method="circulant", corr_length=0.3)).level_instance(
                        [1 / 8], [1 / 4]))):
    fine, coarse, failed = cls.calculate_keyed_batch(level.config_dict, 1, 1, idx,
                                                     torch.zeros_like(idx))
    assert fine.shape[0] == 4 and bool(torch.isfinite(fine).all()) and not bool(failed.any())
x, over = reactions.ssa_exact(reactions.dimerization(), 0.01, SampleKeys(1, 0, idx), 16)
assert x.shape == (4, 2)
res = american.lsmc_price(american.put_payoff(1.0), 1.0, 0.06, 1.0, 4, sigma=0.2,
                          n_paths=256, device="cpu")
assert res["coef"].shape == (3, 4) and np.isfinite(res["price"])
res = bsde.solve_bsde(sde.gbm(0.05, 0.2, 1.0), lambda x: torch.clamp(x - 1.0, min=0.0),
                      lambda t, x, y, z: -0.05 * y, 1.0, 4, n_paths=256, device="cpu")
assert np.isfinite(res["y0"])
res = sensitivity.sobol_indices(lambda u: u[:, 0] + u[:, 1] ** 2, 2, n=256,
                                n_randomizations=2, device="cpu")
assert res.first_order.shape == (2,)
u = mt.UnbiasedMLMC(nested.nested_level_fn(nested.gaussian_information_fn(), n0=2),
                    mt.GeometricLevels(0.4), chunk_size=64, device="cpu")
u.sample(64)
assert np.isfinite(u.estimates()["mean"])
from mlmc_tpu_torch import mcmc, mimc, mlblue, multifidelity, oed, risk
prob = mcmc.make_darcy_inverse([16], n_modes=8)
obs, flux = prob["forward"](torch.randn(4, prob["d"], dtype=torch.float64), 16)
assert obs.shape == (4, 9) and bool(torch.isfinite(flux).all())
fn, _ = mimc.heat_mimc_value_fn(n_modes=8)
m = mimc.MIMC(fn, mimc.total_degree_set(2, 1), chunk_size=16, device="cpu")
m.extend((1, 0), 16)
assert m.n_samples.tolist() == [0, 0, 16] and np.isfinite(m.estimates()[0]).all()
from mlmc_tpu_torch.tool import process_base, validation, distribution, config
from mlmc_tpu_torch.plot import plots, violinplot
import os
import tempfile
from mlmc_tpu_torch import native
with tempfile.TemporaryDirectory() as tmp:
    try:
        mt.SampleStorageHDF(os.path.join(tmp, "run.hdf5"))
    except ImportError as exc:
        assert "h5py" in str(exc), exc
    else:
        raise AssertionError("SampleStorageHDF opened without h5py")
    if native.available():
        # a run into the binary log, reopened and estimated
        def run(counts):
            log = mt.SampleStorageBin(os.path.join(tmp, "run"))
            s = mt.Sampler(log, mt.DeviceBatchPool(seed=1, device="cpu"), sim,
                           [[0.5], [0.25]])
            s.set_initial_n_samples(counts)
            s.schedule_samples()
            s.ask_sampling_pool_for_samples()
            log.close()
        run([300, 60])
        run([500, 100])
        log = mt.SampleStorageBin(os.path.join(tmp, "run"))
        assert log.get_n_collected() == [500, 100] and log.unfinished_ids() == []
        for a, b in zip(log.sample_pairs(), storage.sample_pairs()):
            assert np.array_equal(a, b.double().numpy())
        root = mt.make_root_quantity(log, sim.result_format(), device="cpu")
        e2 = mt.Estimate(root["length"][1]["10"][0, 0], log, mt.Legendre(5, (-4, 4)))
        assert np.array_equal(e2.estimate_moments_fast()[0], e.estimate_moments_fast()[0])
        log.close()
        print("bin-round-trip-ok")
    else:
        print("bin-round-trip-skipped:", native.build_error())
    mesh_file = os.path.join(tmp, "m.msh")
    with open(mesh_file, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n4\n1 0 0 0\n"
                "2 1 0 0\n3 0 1 0\n4 1 1 0\n$EndNodes\n$Elements\n2\n"
                "1 2 2 1 1 1 2 3\n2 2 2 1 1 2 4 3\n$EndElements\n")
    mesh = mt.FlowSim.extract_mesh(mesh_file)
    assert mesh["points"].shape == (2, 2), mesh
    print("gmsh-parsed-by:", "native" if mt.FlowSim.parsers["native"] else "python")
res = mt.esmda(lambda th: th, [0.1, 0.2], 0.5, n_ens=16, d=2, device="cpu")
assert res["theta"].shape == (16, 2)
gp = mt.GP(device="cpu").fit(np.linspace(0, 1, 6)[:, None], np.sin(np.arange(6.0)), n_steps=3)
assert np.isfinite(gp.predict(np.zeros((2, 1)))[0]).all()
assert abs(mt.SparseGrid(2, 2).integrate(lambda th: th[:, 0] ** 2, device="cpu") - 1.0) < 1e-12
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m in ("jax", "mlmc_tpu", "h5py", "yaml", "optax")
               or m.startswith(("jax.", "mlmc_tpu.", "h5py.", "yaml.", "optax.")))]
assert not loaded, loaded
print("isolated-ok")
"""


def test_import_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(REPO),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "isolated-ok" in proc.stdout
    assert "bin-round-trip-" in proc.stdout and "gmsh-parsed-by:" in proc.stdout


def test_no_jax_imports_in_sources():
    """No source imports jax, mlmc_tpu, optax, sklearn or gstools. ``h5py`` is
    imported only by ``tool/hdf5.py`` (and by the chip script's optional
    HDF5 pass) and ``yaml`` anywhere, but both only inside a function
    (indented), so the package imports on a machine that lacks them."""
    never = re.compile(
        r"^\s*(import|from)\s+(jax|mlmc_tpu|optax|sklearn|gstools)\b", re.M)
    top_level = re.compile(r"^(import|from)\s+(h5py|yaml)\b", re.M)
    h5py_at_all = re.compile(r"^\s*(import|from)\s+h5py\b", re.M)
    h5py_allowed = {REPO / "mlmc_tpu_torch" / "tool" / "hdf5.py",
                    REPO / "chip_smoke.py"}
    files = sorted((REPO / "mlmc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for name in ("tool/hdf5.py", "tool/config.py", "tool/process_base.py",
                 "tool/gmsh_io.py", "tool/stats_tests.py", "plot/plots.py",
                 "sim/diffusion3d.py", "random/frac_geom.py", "sim/flow_sim.py",
                 "mimc.py", "multifidelity.py", "mlblue.py", "risk.py", "mcmc.py",
                 "oed.py", "eki.py", "smc.py", "particle.py", "filter.py", "rare.py",
                 "pod.py", "collocation.py", "pce.py", "gp.py"):
        assert (REPO / "mlmc_tpu_torch" / name) in files, name
    offenders = []
    for f in files:
        text = f.read_text()
        if (never.search(text) or top_level.search(text)
                or (f not in h5py_allowed and h5py_at_all.search(text))):
            offenders.append(str(f))
    assert not offenders, offenders
    assert h5py_at_all.search((REPO / "mlmc_tpu_torch/tool/hdf5.py").read_text())
    # the gmsh parser is the port's own copy of the source
    assert "jax" not in (REPO / "mlmc_tpu_torch/native/gmsh_fast.cpp").read_text()


def _shooting_level():
    sim = mt.ShootingSimulation1D(dict(
        start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
        area_borders=(-100.0, 200.0, -300.0, 400.0), max_time=10.0,
        complexity=5.0, n_modes=16,
        fields_params=dict(model="gauss", corr_length=1.0, sigma=0.5, log=False)))
    return sim.level_instance([0.1], [0.5]).config_dict


def _darcy_level():
    sim = mt.DiffusionSimulation(dict(field_method="circulant", corr_length=0.3))
    return sim.level_instance([1 / 8], [1 / 4]).config_dict


def _path_level(cls, **config):
    return lambda: cls(config).level_instance([1 / 8], [1 / 4]).config_dict


#: the path simulations: (class, level config, result width)
_PATH_SIMS = {
    "sde": (sde.SDESimulation, _path_level(sde.SDESimulation, scheme="milstein"), 1),
    "sde_system": (sde.SDESystemSimulation, _path_level(
        sde.SDESystemSimulation, model="heston", qoi="functionals"), 8),
    "jump_diffusion": (jumps.JumpDiffusionSimulation,
                       _path_level(jumps.JumpDiffusionSimulation), 1),
    "variance_gamma": (levy.VarianceGammaSimulation,
                       _path_level(levy.VarianceGammaSimulation), 1),
    "rbergomi": (rough.RBergomiSimulation, _path_level(rough.RBergomiSimulation), 1),
    "spde": (spde.SPDESimulation, lambda: spde.SPDESimulation().level_instance(
        [1 / 8, 0.5 / 8], [1 / 4, 0.5 / 4]).config_dict, 1),
    "reactions": (reactions.ReactionSimulation,
                  _path_level(reactions.ReactionSimulation, dtype="float64"), 2),
    "transport": (transport.TransportSimulation, lambda: transport.TransportSimulation(dict(
        field_method="circulant", corr_length=0.3, dtype="float64")).level_instance(
        [1 / 8], [1 / 4]).config_dict, 40),
}


def _darcy3d_level():
    return mt.DiffusionSimulation3D(dict(n_modes=16)).level_instance([1 / 4], [1 / 2]).config_dict


def _fractured_level():
    return frac_geom.FracturedDiffusionSimulation(dict(
        field_method="circulant", corr_length=0.3, n_fractures=6)).level_instance(
        [1 / 8], [1 / 4]).config_dict


def _fractured3d_level():
    return frac_geom.FracturedDiffusionSimulation3D(dict(
        n_modes=16, n_fractures=6)).level_instance([1 / 4], [1 / 2]).config_dict


_TRIANGLE = {"points": np.array([[0.2, 0.3], [0.6, 0.5]]),
             "point_region_ids": np.array([1, 1]), "region_map": {"bulk": 1}}
_FLOW_CONFIG = {"fields_params": dict(model="fourier", dim=2, mode_no=8),
                "fields_used_params": ["conductivity"]}


def _host_estimate():
    """An Estimate whose quantity's root asks for the card."""
    sim = mt.SynthSimulation()
    storage = mt.Memory()
    storage.save_global_data(result_format=sim.result_format(),
                             level_parameters=[[0.5]])
    root = mt.make_root_quantity(storage, sim.result_format())
    return mt.Estimate(root["length"][1]["10"][0, 0], storage, mt.Legendre(3, (-1, 1)))


def _host_pool_sample(pool):
    """One shooting sample through a host pool that names no device: the
    pool reports a failure of ``calculate`` as a failed sample, so raise
    the failure's own message."""
    sim = mt.ShootingSimulation1D(dict(
        start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
        area_borders=(-100.0, 200.0, -300.0, 400.0), max_time=10.0,
        complexity=5.0, n_modes=16,
        fields_params=dict(model="gauss", corr_length=1.0, sigma=0.5, log=False)))
    sampler = mt.Sampler(mt.Memory(), pool, sim, [[0.5]])
    sampler.set_initial_n_samples([1])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples(sleep=0.01)
    for failures in sampler.sample_storage._levels[0].failed:
        raise RuntimeError(failures[1])


def _default_device_calls():
    """Entry points called without a device: each must pick the card."""
    x = np.zeros(64, np.float32)
    return {
        "shooting_calculate_batch": lambda: mt.ShootingSimulation1D.calculate_batch(
            _shooting_level(), None, 4),
        "shooting_2d_calculate_batch": lambda: mt.ShootingSimulation2D.calculate_batch(
            _shooting_level(), None, 4),
        "diffusion_calculate_batch": lambda: mt.DiffusionSimulation.calculate_batch(
            _darcy_level(), None, 4),
        "shooting_calculate": lambda: mt.ShootingSimulation1D.calculate(
            _shooting_level(), 5),
        "shooting_2d_calculate": lambda: mt.ShootingSimulation2D.calculate(
            _shooting_level(), 5),
        "diffusion_calculate": lambda: mt.DiffusionSimulation.calculate(
            _darcy_level(), 5),
        "diffusion3d_calculate_batch": lambda: mt.DiffusionSimulation3D.calculate_batch(
            _darcy3d_level(), None, 2),
        "diffusion3d_calculate": lambda: mt.DiffusionSimulation3D.calculate(
            _darcy3d_level(), 5),
        "fractured_calculate_batch": lambda: frac_geom.FracturedDiffusionSimulation
        .calculate_batch(_fractured_level(), None, 2),
        "fractured_calculate": lambda: frac_geom.FracturedDiffusionSimulation.calculate(
            _fractured_level(), 5),
        "fractured3d_calculate_batch": lambda: frac_geom.FracturedDiffusionSimulation3D
        .calculate_batch(_fractured3d_level(), None, 2),
        "fractured3d_calculate": lambda: frac_geom.FracturedDiffusionSimulation3D.calculate(
            _fractured3d_level(), 5),
        "flow_sim_fields": lambda: mt.FlowSim._draw_fields(
            _FLOW_CONFIG, 5, _TRIANGLE, None),
        "flow_sim_calculate": lambda: mt.FlowSim.calculate(
            {"fine": {"common_files_dir": "missing"}, "coarse": {"step": 0}}, 5),
        "create_corr_field": lambda: create_corr_field(model="fourier", mode_no=8),
        "spatial_field": lambda: mt.SpatialCorrelatedField(dim=2),
        "spectral_field": lambda: mt.SpectralCorrelatedField(dim=2, mode_no=8),
        "circulant_field": lambda: mt.CirculantEmbeddingField(
            dim=2, grid_shape=(4, 4)),
        "level_config_from_jax": lambda: mt.level_config_from_jax({"fine_n": 4}),
        "bootstrap_and_subsample": lambda: _host_estimate(),

        "synth_mlmc_pipeline": lambda: mt.synth_mlmc_pipeline(
            0, 5, (100,), (0.5,), domain=(-4, 4)),
        "from_noise_numpy": lambda: mt.synth_moment_pipeline_from_noise(
            x, 5, fine_step=0.5, coarse_step=0.25, domain=(-4, 4)),
        "synth_normals": lambda: mt.synth_normals(0, 64),
        "samples_numpy": lambda: mt.moment_pipeline_from_samples(
            x, x, 5, domain=(-4, 4)),
        "samples_extended_numpy": lambda: mt.moment_pipeline_from_samples_extended(
            x, x, 5, domain=(-4, 4)),
        "one_process_pool_sample": lambda: _host_pool_sample(mt.OneProcessPool()),
        "thread_pool_sample": lambda: _host_pool_sample(mt.ThreadPool(2)),
        "device_memory": lambda: mt.DeviceMemory(),
        "device_batch_pool": lambda: mt.DeviceBatchPool(),
        "root_of_host_memory": lambda: mt.make_root_quantity(
            mt.Memory(), mt.SynthSimulation().result_format()),
        "fused_mlmc": lambda: mt.FusedMLMC([], mt.Legendre(3, (-1, 1))),
        "fused_mlmc_moments": lambda: mt.fused_mlmc_moments(
            [], mt.Legendre(3, (-1, 1)), 0, []),
        "simple_distribution": lambda: mt.SimpleDistribution(
            mt.Legendre(3, (-1, 1)), np.ones((3, 2))),
        "sample_mesh": lambda: mt.SampleMesh(),
        "global_sample_mesh": lambda: multihost.global_sample_mesh(),
        "sampling_pool_pbs": lambda: mt.SamplingPoolPBS(),
        "fused_mlmc_mesh_of_the_card": lambda: mt.FusedMLMC(
            [], mt.Legendre(3, (-1, 1)), mesh=mt.SampleMesh()),
        "multilevel_cdf": lambda: mt.MultilevelCDF(
            _pair, 2, [0.0, 1.0], 0.1),
        "cmlmc": lambda: mt.cmlmc(_pair, [0.5, 0.25], eps=1e-2),
        "ml2r": lambda: mt.ml2r(_pair, [0.5, 0.25], target_var=1e-4),
        "unbiased_mlmc": lambda: mt.UnbiasedMLMC(
            lambda level, keys: keys.indices * 0.0, mt.GeometricLevels(0.5)),
        "mlqmc": lambda: mt.MLQMC(*mt.synth_qmc_level_fns([[0.5]])),
        "lattice_estimate": lambda: mt.lattice_estimate(lambda u: u[:, 0], 2, n=64),
        "sobol_bits": lambda: sobol.sobol_bits(sobol.direction_numbers(2), 0, 8),
        "lsmc_price": lambda: mt.lsmc_price(mt.put_payoff(1.0), 1.0, 0.06, 1.0, 4,
                                            sigma=0.2, n_paths=64),
        "solve_bsde": lambda: mt.solve_bsde(mt.gbm(), lambda x: x, _zero_driver, 1.0, 4,
                                            n_paths=64),
        "sobol_indices": lambda: mt.sobol_indices(lambda u: u[:, 0], 2, n=64),
        "nested_unbiased_mlmc": lambda: mt.UnbiasedMLMC(
            mt.nested_level_fn(nested.gaussian_information_fn()), mt.GeometricLevels(0.5)),
        "mimc": lambda: mt.MIMC(mt.heat_mimc_value_fn()[0], [(0, 0)]),
        "mfmc": lambda: mt.MFMC(_fidelity_models()),
        "mlblue": lambda: mt.mlblue(_fidelity_models(), [1.0, 0.1, 0.01], budget=10.0),
        "cvar_mlmc": lambda: mt.cvar_mlmc(_pair, 1, 0.9, 0.1, 0.1),
        "mlmc_gradient": lambda: mt.mlmc_gradient(_objective, np.ones(1), 1, 8),
        "optimize_expectation": lambda: mt.optimize_expectation(_objective, np.ones(1), 1, 8,
                                                                n_steps=1),
        "run_pcn": lambda: mt.run_pcn(_toy_loglik, 2, 2),
        "run_coupled": lambda: mt.run_coupled(_toy_loglik, _toy_loglik, 2, 2),
        "run_mlda": lambda: mt.run_mlda([_toy_loglik, _toy_loglik], 2, 2),
        "run_unbiased": lambda: mt.run_unbiased(_toy_loglik, 2, k=1, m=2),
        "mlmcmc": lambda: mt.MLMCMC([_toy_loglik], 2).run(2),
        "darcy_inverse_synthetic": lambda: mt.make_darcy_inverse([8], n_modes=4)["synthetic"](0),
        "eig_nmc": lambda: mt.eig_nmc(lambda th: th, 0.5, 2, n_outer=8, n_inner=4),
        "expected_information_gain": lambda: mt.expected_information_gain(
            lambda th: th, 0.5, 2),
        "esmda": lambda: mt.esmda(lambda th: th, [0.0], 1.0, n_ens=4, d=1),
        "hierarchical_esmda": lambda: mt.hierarchical_esmda([lambda th: th], [0.0], 1.0,
                                                            n_ens=4, d=1),
        "smc_tempering": lambda: mt.smc_tempering(_toy_loglik, 2, n_particles=16),
        "hierarchical_smc": lambda: mt.hierarchical_smc([_toy_loglik] * 2, 2,
                                                        n_particles=16),
        "particle_filter": lambda: mt.particle_filter(
            _toy_transition, _toy_obs_loglik, np.zeros((2, 1)), 16, 1),
        "multilevel_particle_filter": lambda: mt.multilevel_particle_filter(
            lambda lev: _toy_transition, _toy_obs_loglik, np.zeros((2, 1)), 2, 1,
            n_particles=16),
        "enkf": lambda: mt.enkf(_toy_transition, lambda x: x, np.zeros((2, 1)), 1.0, 8, 1),
        "multilevel_enkf": lambda: mt.multilevel_enkf(
            lambda lev: _toy_transition, lambda x: x, np.zeros((2, 1)), 1.0, 2, 1, n_ens=8),
        "subset_simulation": lambda: mt.subset_simulation(lambda th: th[:, 0], 1.0, 2,
                                                          n_particles=160),
        "cross_entropy_is": lambda: mt.cross_entropy_is(lambda th: th[:, 0], 1.0, 2),
        "pod_darcy_surrogate": lambda: mt.pod_darcy_surrogate(n=8, rank=2, n_snapshots=4),
        "sparse_grid_integrate": lambda: mt.SparseGrid(2, 1).integrate(lambda th: th[:, 0]),
        "adaptive_sparse_grid": lambda: mt.AdaptiveSparseGrid(2).integrate(
            lambda th: th[:, 0]),
        "multilevel_collocation": lambda: mt.multilevel_collocation(
            [lambda th: th[:, 0]], 2),
        "pce": lambda: mt.PCE(2, 1),
        "gp": lambda: mt.GP(),
        "multilevel_gp": lambda: mt.MultilevelGP(),
        "bayes_opt": lambda: mt.bayes_opt(lambda x: float(x.sum()), [[0.0, 1.0]], n_init=2,
                                          n_iter=1),
        **{"%s_%s" % (name, call): (
            lambda sim=sim, level=level, call=call: (
                sim.calculate_batch(level(), None, 4) if call == "calculate_batch"
                else sim.calculate(level(), 5)))
           for name, (sim, level, _) in _PATH_SIMS.items()
           for call in ("calculate_batch", "calculate")},
    }


def _zero_driver(t, x, y, z):
    return torch.zeros_like(y)


def _fidelity_models():
    from mlmc_tpu_torch.multifidelity import synth_fidelity_models

    return synth_fidelity_models()


def _objective(level, theta, keys):
    x = keys.normals(1)[:, 0].double() * theta[0]
    return x, x, torch.ones_like(x, dtype=torch.bool)


def _toy_loglik(theta):
    return -0.5 * (theta * theta).sum(1), theta[:, :1]


def _toy_transition(x, keys, t):
    return 0.9 * x + keys.normals(x.shape[1], x.dtype)


def _toy_obs_loglik(x, y):
    return -0.5 * ((x - y) ** 2).sum(1)


def _pair(level, keys):
    x = keys.normals(1)[:, 0].double()
    return x, x, torch.ones_like(x, dtype=torch.bool)


@pytest.mark.parametrize("name", sorted(_default_device_calls()))
def test_entry_points_default_to_the_card(name):
    """With no device named, an entry point runs on the current CUDA
    device; without a card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the call runs on it instead")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)   # the PBS shim's
        with pytest.raises(RuntimeError, match="is_available"):
            _default_device_calls()[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("sim,level,width", [
    (mt.ShootingSimulation1D, _shooting_level, 1),
    (mt.ShootingSimulation2D, _shooting_level, 2),
    (mt.DiffusionSimulation, _darcy_level, 1),
    (mt.DiffusionSimulation3D, _darcy3d_level, 1),
    (frac_geom.FracturedDiffusionSimulation, _fractured_level, 1),
    (frac_geom.FracturedDiffusionSimulation3D, _fractured3d_level, 1)]
    + list(_PATH_SIMS.values()))
def test_simulations_default_to_the_card_on_a_card(sim, level, width):
    """With a card and nothing named, a batch draws from a fresh generator
    on the card and stays there; ``calculate`` computes there and returns
    host arrays, the same for a seed as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the default device is the card")
    fine, coarse, failed = sim.calculate_batch(level(), None, 4)
    assert fine.is_cuda and fine.shape == coarse.shape == (4, width)
    assert failed.shape == (4,) and not bool(failed.any())
    on_card, on_host = (sim.calculate(level(), 5, device=d) for d in (None, "cpu"))
    assert isinstance(on_card[0], np.ndarray) and on_card[0].shape == (width,)
    np.testing.assert_allclose(on_card[0], on_host[0], rtol=1e-4)   # float32
    np.testing.assert_allclose(on_card[1], on_host[1], rtol=1e-4)


@pytest.mark.cuda
def test_flow_sim_fields_default_to_the_card_on_a_card():
    """FlowSim's joint field is computed on the card when nothing is named,
    and equals the CPU's for the same seed (the draws come from a host
    generator)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the default device is the card")
    on_card = mt.FlowSim._draw_fields(_FLOW_CONFIG, 5, _TRIANGLE, None)
    on_host = mt.FlowSim._draw_fields(_FLOW_CONFIG, 5, _TRIANGLE, None, device="cpu")
    assert isinstance(on_card[0]["conductivity"], np.ndarray)
    np.testing.assert_allclose(on_card[0]["conductivity"], on_host[0]["conductivity"],
                               rtol=1e-12)


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


@pytest.mark.cuda
def test_qmc_defaults_to_the_card_on_a_card():
    """MLQMC and lattice_estimate make their points on the card when no
    device is named, and equal the CPU's run (float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the default device is the card")
    fns, dims = mt.synth_qmc_level_fns([[0.5], [0.25]])
    runs = []
    for device in (None, "cpu"):
        ml = mt.MLQMC(fns, dims, n_randomizations=4, chunk_size=64, dtype=torch.float64,
                      cost_per_sample=[1, 2], device=device)
        runs.append((ml, ml.run(1e-8, n_init=64)))
    assert runs[0][0]._seeds[0].is_cuda
    assert runs[0][1]["n_samples"].tolist() == runs[1][1]["n_samples"].tolist()
    for a, b in zip(runs[0][0]._levels, runs[1][0]._levels):
        np.testing.assert_allclose(a.sums, b.sums, rtol=1e-12)
    f = lambda u: torch.prod(1.0 + u * u - u, dim=1)
    card, host = (mt.lattice_estimate(f, 4, n=256, n_shifts=4, dtype=torch.float64,
                                      device=d) for d in (None, "cpu"))
    np.testing.assert_allclose(card["per_shift"], host["per_shift"], rtol=1e-12)


@pytest.mark.cuda
def test_first_users_default_to_the_card_on_a_card():
    """lsmc_price, solve_bsde, sobol_indices and a nested level function
    under UnbiasedMLMC compute on the card when no device is named, and
    equal the CPU's run: float64 paths, but the keyed normals are computed
    in float32 (the card's and the CPU's log and cos may differ in the last
    bit), so to 1e-5 where the draws are normals; the Sobol' design is
    integer-exact, so to 1e-10 there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the default device is the card")
    f64 = torch.float64
    runs = [mt.lsmc_price(mt.put_payoff(1.0), 1.0, 0.06, 1.0, 6, sigma=0.2, n_paths=1024,
                          dtype=f64, device=d) for d in (None, "cpu")]
    np.testing.assert_allclose(runs[0]["coef"], runs[1]["coef"], rtol=1e-5, atol=1e-8)
    assert abs(runs[0]["price"] - runs[1]["price"]) < 1e-3
    runs = [mt.solve_bsde(mt.gbm(0.05, 0.2, 1.0), lambda x: torch.clamp(x - 1.0, min=0.0),
                          lambda t, x, y, z: -0.05 * y, 1.0, 8, n_paths=2048, dtype=f64,
                          device=d) for d in (None, "cpu")]
    np.testing.assert_allclose(runs[0]["y0"], runs[1]["y0"], rtol=1e-5)
    runs = [mt.sobol_indices(lambda u: u[:, 0] + u[:, 1] ** 2, 2, n=1024,
                             n_randomizations=4, dtype=f64, device=d) for d in (None, "cpu")]
    np.testing.assert_allclose(runs[0].first_order, runs[1].first_order, rtol=1e-10)
    fn = mt.nested_level_fn(nested.gaussian_information_fn(1.3, 2.0, 0.2), n0=4)
    runs = []
    for d in (None, "cpu"):
        u = mt.UnbiasedMLMC(fn, mt.GeometricLevels(0.4), chunk_size=256, device=d)
        u.sample(512)
        runs.append(u.estimates())
    np.testing.assert_allclose(runs[0]["mean"], runs[1]["mean"], rtol=1e-5)


@pytest.mark.cuda
def test_drivers_and_chains_default_to_the_card_on_a_card():
    """MIMC.extend, a 5-step run_pcn over a Darcy inverse batch and eig_nmc
    run on the card when no device is named and equal the CPU's run
    (float64; the keyed uniforms and normals are integer-derived, so only
    the card's and the CPU's transcendentals may differ in the last bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the default device is the card")
    fn, _ = mt.heat_mimc_value_fn(n_modes=16)
    sums = []
    for d in (None, "cpu"):
        m = mt.MIMC(fn, mt.total_degree_set(2, 2), chunk_size=256, device=d)
        for a in m.index_set:
            m.extend(a, 512)
        sums.append(m.estimates())
    for a, b in zip(*sums):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-15)
    prob = mt.make_darcy_inverse([16], n_modes=8)
    _, _, data = prob["synthetic"](3, device="cpu")
    (ll,) = prob["loglik_qoi_fns"](data)
    runs = [mt.run_pcn(ll, prob["d"], 5, n_chains=8, seed=1, device=d) for d in (None, "cpu")]
    assert runs[0].acc_rate == runs[1].acc_rate
    np.testing.assert_allclose(runs[0].qoi, runs[1].qoi, rtol=1e-6)
    fwd = lambda th: prob["forward"](th, 16)[0]
    eig = [mt.eig_nmc(fwd, 0.05, prob["d"], n_outer=64, n_inner=16, chunk_size=32, device=d)
           for d in (None, "cpu")]
    np.testing.assert_allclose(eig[0]["eig"], eig[1]["eig"], rtol=1e-6)


def _mlmc_tpu_exports():
    """The public names ``mlmc_tpu/__init__.py`` exports: what its top-level
    ``from mlmc_tpu... import`` statements bind, its public classes and
    functions, and ``__version__`` (read as source: no JAX import)."""
    import ast

    tree = ast.parse((REPO / "mlmc_tpu" / "__init__.py").read_text())
    names = {"__version__"}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("mlmc_tpu"):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Try):
            for sub in node.body:
                if isinstance(sub, ast.ImportFrom) and (sub.module or "").startswith("mlmc_tpu"):
                    names.update(a.asname or a.name for a in sub.names)
        elif isinstance(node, (ast.ClassDef, ast.FunctionDef)) and not node.name.startswith("_"):
            names.add(node.name)
    return names


def test_every_mlmc_tpu_export_is_ported():
    names = _mlmc_tpu_exports()
    assert {"esmda", "smc_tempering", "particle_filter", "pod_darcy_surrogate",
            "SparseGrid", "PCE", "GP", "bayes_opt", "SamplingPoolPBS"} <= names
    assert len(names) > 150
    missing = sorted(n for n in names if not hasattr(mt, n))
    assert not missing, missing


@pytest.mark.cuda
def test_inference_and_surrogates_run_on_the_card():
    """esmda, smc_tempering, particle_filter, subset_simulation,
    SparseGrid.integrate, PCE.fit_regression and GP.fit compute on the card
    when no device is named and equal the CPU's run (float64; the keyed
    draws are integer-derived, the float32 Box-Muller normals of the
    filters' keys may differ in the last bit between the card's and the
    CPU's transcendentals, so 1e-6 there; accept and resampling decisions
    must agree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the default device is the card")
    A = torch.tensor(np.random.default_rng(0).normal(size=(5, 3)))
    y = np.random.default_rng(1).normal(size=5)
    runs = [mt.esmda(lambda th: th @ A.to(th.device).T, y, 0.5, n_ens=256, d=3, device=d)
            for d in (None, "cpu")]
    np.testing.assert_allclose(runs[0]["theta"], runs[1]["theta"], rtol=1e-9, atol=1e-12)

    def ll(th):
        r = th @ A.to(th.device).T - torch.as_tensor(y, device=th.device)
        return -0.5 * (r * r).sum(1) / 0.25, th
    runs = [mt.smc_tempering(ll, 3, n_particles=256, device=d) for d in (None, "cpu")]
    assert runs[0]["lambdas"] == pytest.approx(runs[1]["lambdas"], rel=1e-9)
    np.testing.assert_allclose(runs[0]["theta"], runs[1]["theta"], rtol=1e-8, atol=1e-10)
    ys = np.random.default_rng(2).normal(size=(10, 1))
    runs = [mt.particle_filter(_toy_transition, _toy_obs_loglik, ys, 1024, 1, device=d)
            for d in (None, "cpu")]
    np.testing.assert_allclose(runs[0]["means"], runs[1]["means"], rtol=1e-6, atol=1e-8)
    runs = [mt.subset_simulation(lambda th: th[:, 0], 3.0, 2, n_particles=512, device=d)
            for d in (None, "cpu")]
    assert runs[0]["thresholds"] == pytest.approx(runs[1]["thresholds"], rel=1e-9)
    assert runs[0]["log_p"] == pytest.approx(runs[1]["log_p"], rel=1e-9)
    f = lambda th: torch.exp(0.3 * th[:, 0] - 0.2 * th[:, 1])
    vals = [mt.SparseGrid(2, 4).integrate(f, device=d) for d in (None, "cpu")]
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-13)
    theta = np.random.default_rng(3).normal(size=(200, 3))
    fits = [mt.PCE(3, 3, device=d).fit_regression(theta, np.sin(theta[:, 0]) * theta[:, 1])
            for d in (None, "cpu")]
    np.testing.assert_allclose(fits[0].coefficients.cpu().numpy(),
                               fits[1].coefficients.numpy(), rtol=1e-9, atol=1e-12)
    X = np.random.default_rng(4).uniform(size=(20, 2))
    gps = [mt.GP(device=d).fit(X, np.sin(4 * X[:, 0]) + X[:, 1], n_steps=50)
           for d in (None, "cpu")]
    np.testing.assert_allclose(gps[0].nll_trace, gps[1].nll_trace, rtol=1e-8)
