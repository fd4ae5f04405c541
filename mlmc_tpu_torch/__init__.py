"""mlmc_tpu_torch — ``mlmc_tpu``'s MLMC paths in PyTorch, with their
sample -> moment kernels written in CUDA for Hopper: the storage-free path
(``FusedMLMC``, ``synth_mlmc_pipeline``) and the stored-samples path
(``Sampler`` -> ``DeviceBatchPool`` -> ``DeviceMemory`` -> ``Quantity`` ->
``Estimate``), with the synthetic, the shooting-ODE and the Darcy-flow
simulations and the correlated random fields as tensor code. Runs that
outlive the process go through the file-backed storages
(``SampleStorageHDF``, ``SampleStorageBin``); host simulations run in the
``OneProcessPool`` / ``ProcessPool`` / ``ThreadPool`` with per-sample
workspaces. The sample mesh (``parallel``) spreads samples over several
devices and processes. The 3-D and fractured Darcy simulations
(``DiffusionSimulation3D``, ``random/frac_geom``), the external-binary
simulations (``FlowSim``, ``sim/external``) and the reference library's
tools (``tool/process_base``, ``tool/validation``, ``tool/gmsh_io``, the
legacy maxent ``tool/distribution``, ``plot/``) sit under their module
paths. Quasi-Monte Carlo (``MLQMC`` over Owen-scrambled Sobol' points or
extensible rank-1 lattices, ``lattice_estimate``) and the SDE path family
(``SDESimulation``, the Heston system, Merton jumps, variance gamma,
rBergomi, the unbiased SDE ladder ``sde_unbiased_level_fn``) run as
tensor code and feed the same stored-sample path, and so do the stochastic
heat / Allen-Cahn SPDEs (``SPDESimulation``), tau-leaped reaction networks
(``ReactionSimulation``, ``ssa_exact``) and solute transport on the Darcy
field (``TransportSimulation``). Their first users: Longstaff-Schwartz
Bermudan pricing with its dual bounds and swing options (``lsmc_price``),
the BSDE solver (``solve_bsde``), Sobol' sensitivity indices and active
subspaces (``sobol_indices``), and nested expectations (``nested``). The
drivers beyond MLMC: multi-index MC (``MIMC``), multifidelity MC
(``MFMC``), multilevel BLUEs (``mlblue``), tail risk and optimization
under uncertainty (``cvar_mlmc``, ``optimize_cvar``), multilevel MCMC on
batched likelihoods (``MLMCMC``, ``run_pcn``, ``make_darcy_inverse``) and
expected information gain (``eig_nmc``). Inference: ensemble Kalman
inversion (``esmda``), tempered SMC (``smc_tempering``), subset simulation
and cross-entropy importance sampling, ensemble Kalman and particle
filters with their multilevel forms (``enkf``, ``particle_filter``).
Surrogates: POD reduced bases (``pod_darcy_surrogate``), sparse-grid
collocation (``SparseGrid``), polynomial chaos (``PCE``) and Gaussian
processes (``GP``, ``bayes_opt``).

Module paths and public names mirror ``mlmc_tpu``: the counterpart of
``mlmc_tpu/X.py`` is ``mlmc_tpu_torch/X.py``. Importing the package has no
side effects; the CUDA kernels build at their first launch.
"""
from mlmc_tpu_torch.moments import (
    Moments, Monomial, Fourier, Legendre, TransformedMoments)
from mlmc_tpu_torch.random.distributions import (
    Norm, LogNorm, Uniform, TwoGaussians, TorchDistr, as_torch_distr)
from mlmc_tpu_torch.sim.simulation import Simulation
from mlmc_tpu_torch.sim.synth_simulation import SynthSimulation
from mlmc_tpu_torch.sim.synth_simulation_workspace import (
    SynthSimulationWorkspace)
from mlmc_tpu_torch.sim.shooting import ShootingSimulation1D, ShootingSimulation2D
from mlmc_tpu_torch.sim.diffusion import DiffusionSimulation
from mlmc_tpu_torch.sim.diffusion3d import DiffusionSimulation3D
from mlmc_tpu_torch.sim.flow_sim import FlowSim
from mlmc_tpu_torch.random.correlated_field import (
    SpatialCorrelatedField, SpectralCorrelatedField, CirculantEmbeddingField,
    GSToolsSpatialCorrelatedField, FourierSpatialCorrelatedField, Field, Fields)
from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.ops.fused_estimate import (
    MomentAccumulators, accumulators_to_estimates, fused_level_moments,
    fused_mlmc_moments)
from mlmc_tpu_torch.ops.cuda_kernels import (
    SynthMomentResult, synth_mlmc_pipeline, synth_mlmc_pipeline_from_noise,
    synth_moment_pipeline, synth_moment_pipeline_from_noise, synth_normals,
    moment_pipeline_from_samples, mlmc_moment_pipeline_from_samples,
    pack_level_samples)
from mlmc_tpu_torch.ops.cuda_extended import (
    ExtendedMomentResult, moment_pipeline_from_samples_extended,
    synth_moment_pipeline_from_noise_extended)
from mlmc_tpu_torch.estimator import (
    Estimate, estimate_domain, estimate_n_samples_for_target_variance,
    calc_level_params, determine_level_parameters, determine_n_samples,
    estimate_convergence_rates, richardson_extrapolation)
from mlmc_tpu_torch.fused_driver import (
    FusedMLMC, level_sim_chunk_fn, sim_level_chunk_fns)
from mlmc_tpu_torch.tool.simple_distribution import (
    SimpleDistribution, construct_ortogonal_moments)
from mlmc_tpu_torch.sample_storage import SampleStorage, Memory, DeviceMemory
from mlmc_tpu_torch.sample_storage_hdf import SampleStorageHDF
try:  # the native engine builds at first use; only a broken module hides it
    from mlmc_tpu_torch.sample_storage_bin import SampleStorageBin
except Exception:  # pragma: no cover
    SampleStorageBin = None
from mlmc_tpu_torch.sampling_pool import (
    SamplingPool, OneProcessPool, ProcessPool, ThreadPool, DeviceBatchPool)
from mlmc_tpu_torch.sampler import Sampler
from mlmc_tpu_torch.parallel import (
    SampleMesh, sample_mesh, sharded_mlmc_step, sharded_synth_pipeline,
    sharded_synth_pipeline_from_noise)


class SamplingPoolPBS(DeviceBatchPool):
    """Compatibility shim for scripts written against the PBS-cluster
    pool: there is no batch-queue backend, cluster fan-out is the sample
    mesh. ``SamplingPoolPBS(work_dir, clean=...)`` is a DeviceBatchPool
    sharded over every visible CUDA device (or over ``device`` alone);
    the PBS options are ignored. See ``parallel.multihost`` for several
    processes.
    """

    def __init__(self, work_dir=None, clean=None, debug=False, device=None,
                 **pbs_kwargs):
        import warnings

        warnings.warn(
            "SamplingPoolPBS is a compatibility shim: samples run as a "
            "sharded device batch, PBS options are ignored",
            DeprecationWarning, stacklevel=2)
        del clean, pbs_kwargs
        mesh = SampleMesh(None if device is None else [device])
        super().__init__(work_dir=work_dir, debug=debug, sharding=mesh,
                         device=device)


from mlmc_tpu_torch.quantity.quantity import (
    Quantity, QuantityConst, QuantityMean, QuantityStorage, make_root_quantity)
from mlmc_tpu_torch.quantity.quantity_spec import ChunkSpec
from mlmc_tpu_torch.quantity.quantity_types import (
    QType, ScalarType, BoolType, ArrayType, TimeSeriesType, FieldType, DictType)
from mlmc_tpu_torch.cdf_estimate import MultilevelCDF, simulation_pair_fn
from mlmc_tpu_torch.cmlmc import cmlmc
from mlmc_tpu_torch.ml2r import ml2r, ml2r_weights
from mlmc_tpu_torch.unbiased import (UnbiasedMLMC, GeometricLevels,
                                     sde_unbiased_level_fn)
from mlmc_tpu_torch.sim.sde import (
    SDESimulation, SDEModel, gbm, ornstein_uhlenbeck, cir,
    black_scholes_call, sde_qmc_level_fns, gbm_call_shift)
from mlmc_tpu_torch.sim.jumps import (JumpDiffusion, JumpDiffusionSimulation,
                                      merton, merton_call_price)
from mlmc_tpu_torch.sim.rough import (RBergomi, rbergomi, RBergomiSimulation,
                                      coupled_rbergomi_paths, rl_fbm_cov)
from mlmc_tpu_torch.sim.levy import (VarianceGamma, variance_gamma,
                                     VarianceGammaSimulation, vg_call_price)
from mlmc_tpu_torch.tool.fourier_pricing import (cos_price, cf_gbm, cf_merton,
                                                 cf_vg, cf_heston)
from mlmc_tpu_torch.qmc import (
    MLQMC, synth_qmc_level_fns, shooting_qmc_level_fns,
    darcy_qmc_level_fns, qmc_level_fns_from_normals,
    moments_qmc_level_fns)
from mlmc_tpu_torch.ops.lattice import lattice_estimate, cbc_vector
from mlmc_tpu_torch.sim.transport import TransportSimulation
from mlmc_tpu_torch.sim.reactions import (ReactionNetwork, ReactionSimulation,
                                          mass_action, immigration_death,
                                          dimerization, schlogl, tau_leap,
                                          coupled_tau_leap, ssa_exact)
from mlmc_tpu_torch.sim.spde import (SPDE1D, stochastic_heat, allen_cahn,
                                     coupled_spde_paths, SPDESimulation,
                                     heat_spde_l2_moment)
from mlmc_tpu_torch.bsde import solve_bsde
from mlmc_tpu_torch.sensitivity import (sobol_indices, sobol_indices_mlmc,
                                        active_subspace)
from mlmc_tpu_torch.nested import nested_level_fn, evppi_level_fn
from mlmc_tpu_torch.sim.american import (lsmc_price, lsmc_dual_bound,
                                         lsmc_dual_bound_ml, lsmc_swing,
                                         bermudan_binomial, put_payoff,
                                         call_payoff)
from mlmc_tpu_torch.mimc import (MIMC, total_degree_set, full_tensor_set,
                                 heat_mimc_value_fn)
from mlmc_tpu_torch.multifidelity import MFMC
from mlmc_tpu_torch.mlblue import mlblue, default_groups
from mlmc_tpu_torch.mcmc import (MLMCMC, run_pcn, run_coupled, run_mlda,
                                 run_unbiased, make_darcy_inverse)
from mlmc_tpu_torch.oed import (eig_nmc, expected_information_gain,
                                linear_gaussian_eig)
from mlmc_tpu_torch.risk import (cvar_empirical, cvar_mlmc, mlmc_gradient,
                                 optimize_expectation, optimize_cvar)
from mlmc_tpu_torch.eki import esmda, hierarchical_esmda
from mlmc_tpu_torch.smc import smc_tempering, hierarchical_smc
from mlmc_tpu_torch.particle import particle_filter, multilevel_particle_filter
from mlmc_tpu_torch.filter import (enkf, multilevel_enkf, kalman_filter,
                                   lorenz96_step)
from mlmc_tpu_torch.rare import subset_simulation, cross_entropy_is
from mlmc_tpu_torch.pod import pod_darcy_surrogate
from mlmc_tpu_torch.collocation import (AdaptiveSparseGrid, SparseGrid,
                                        multilevel_collocation)
from mlmc_tpu_torch.pce import PCE, pce_control_variate, total_degree_indices
from mlmc_tpu_torch.gp import GP, MultilevelGP, bayes_opt
from mlmc_tpu_torch.convert import (
    accumulators_from_jax, field_from_jax, level_config_from_jax,
    mlqmc_from_jax, moments_from_jax, storage_from_jax)

__version__ = "0.1.0"
