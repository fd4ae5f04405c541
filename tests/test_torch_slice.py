"""The storage-free MLMC slice end to end, mlmc_tpu_torch against mlmc_tpu.

5 levels of the synthetic simulation, 2^14 samples per level, R=8
Legendre moments on (-4, 4). Both packages get the same f32 normals, made
with numpy:
* the port runs its memory-mode pipeline (plain version on the CPU), then
  estimates, orthogonalization and the torch maxent solve;
* mlmc_tpu runs its exact f64 reference of the kernel body
  (``f64_reference_moments``; its Pallas noise kernel has no level-0
  mode), then its own estimates, orthogonalization and the JAX f64 solve.
Estimates and the orthogonal basis agree to 1e-10, the density to 1e-8.
"""
import numpy as np
import torch

from mlmc_tpu.ops.fused_estimate import accumulators_to_estimates as j_estimates
from mlmc_tpu.ops.pallas_kernels import SynthMomentResult as JResult
from mlmc_tpu.ops.precision import f64_reference_moments
import mlmc_tpu.moments as jm
import mlmc_tpu.tool.simple_distribution as jsd

import mlmc_tpu_torch as mt
import mlmc_tpu_torch.tool.simple_distribution as tsd
from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates

torch.set_num_threads(1)

R = 8
DOMAIN = (-4.0, 4.0)
STEPS = [0.5, 0.25, 0.125, 0.0625, 0.03125]
N = 1 << 14


def _density(sd, basis, est, backend):
    orto, info = sd.construct_ortogonal_moments(basis, est["cov"], tol=1e-7)
    mu = info[2] @ est["mean"]
    data = np.stack((mu, np.ones(orto.size)), axis=1)
    host = {"device": "cpu"} if sd is tsd else {}
    d = sd.SimpleDistribution(orto, data, domain=DOMAIN, solver_backend=backend,
                              **host)
    return d, d.estimate_density_minimize(tol=1e-9), info


def test_slice_matches_mlmc_tpu():
    rng = np.random.default_rng(2024)
    xs = [rng.normal(size=N).astype(np.float32) for _ in STEPS]

    accs = mt.synth_mlmc_pipeline_from_noise(xs, R, STEPS, domain=DOMAIN,
                                             device="cpu")
    est = accumulators_to_estimates(accs)

    j_accs = []
    for lvl, x in enumerate(xs):
        ref = f64_reference_moments(
            x, R, fine_step=STEPS[lvl],
            coarse_step=STEPS[lvl - 1] if lvl else 0.0, domain=DOMAIN,
            is_level0=(lvl == 0))
        j_accs.append(JResult(ref["sums"], ref["sums2"], ref["cov_fine"],
                              ref["cov_coarse"], ref["n_valid"]))
    j_est = j_estimates(j_accs)
    for key in j_est:
        np.testing.assert_allclose(est[key], j_est[key], rtol=1e-10,
                                   atol=1e-13, err_msg=key)
    assert est["mean"][0] == 1.0

    td, tres, t_info = _density(tsd, mt.Legendre(R, DOMAIN), est, "torch")
    jd, jres, j_info = _density(jsd, jm.Legendre(R, DOMAIN), j_est, "jax")
    assert tres.success and jres.success
    np.testing.assert_allclose(t_info[2], j_info[2], rtol=1e-10, atol=1e-12)
    x = np.linspace(-3.95, 3.95, 200)
    np.testing.assert_allclose(td.density(x), jd.density(x), rtol=1e-8)


def test_rng_slice_reconstructs_a_normal_density():
    """RNG mode (plain version) at the headline's level ladder, scaled
    down: the estimate is normalized and the density is close to N(0,1)."""
    import scipy.stats as st

    accs = mt.synth_mlmc_pipeline(7, 12, [1 << 16, 1 << 14, 1 << 13, 1 << 12,
                                          1 << 11], STEPS, domain=DOMAIN, device="cpu")
    est = accumulators_to_estimates(accs)
    assert est["mean"][0] == 1.0
    assert all(int(a.n_valid) > 0.99 * n for a, n in
               zip(accs, [1 << 16, 1 << 14, 1 << 13, 1 << 12, 1 << 11]))
    d, res, _ = _density(tsd, mt.Legendre(12, DOMAIN), est, "torch")
    assert res.success
    x = np.linspace(-3, 3, 25)
    assert np.max(np.abs(d.density(x) - st.norm.pdf(x))) < 0.03
