"""The reference library's tools in mlmc_tpu_torch against mlmc_tpu's:
``tool/stats_tests``, ``tool/validation``, the legacy maxent
``tool/distribution``, ``tool/config``, ``tool/profiling``,
``tool/process_base`` and ``plot/``.

Inputs are made from a numpy seed and stored identically in both packages
(an ``mlmc_tpu`` ``Memory``, copied by ``storage_from_jax``), f64 on both
sides. Tolerances: stats, validation and legacy-maxent results 1e-10
(the same decisions: a test that passes or raises in one passes or raises
in the other); ``ProcessBase``: mlmc_tpu's ``run`` writes the HDF5 file,
this package's ``process`` reads that file, and its moments equal
mlmc_tpu's ``process`` within 1e-10; plots render and save the files
mlmc_tpu's plots save.
"""
import os

import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.tool import stats_tests as tst
from mlmc_tpu_torch.tool import validation as tval

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

STEPS = [0.1, 0.02, 0.004]
COUNTS = [4000, 1000, 200]


def _qoi(x, h):
    return x + h * np.sqrt(1e-4 + np.abs(x))


def _stores(counts=COUNTS, seed=0):
    """The same synthetic 3-level samples in an mlmc_tpu Memory and in this
    package's Memory (f64)."""
    import mlmc_tpu as jm

    rng = np.random.default_rng(seed)
    jstorage = jm.Memory()
    jstorage.save_global_data(
        result_format=[jm.QuantitySpec(name="q", unit="m", shape=(1,), times=[0],
                                       locations=["x"])],
        level_parameters=[[h] for h in STEPS[:len(counts)]])
    for lid, n in enumerate(counts):
        x = rng.normal(size=n)
        fine = _qoi(x, STEPS[lid])[:, None]
        coarse = _qoi(x, STEPS[lid - 1])[:, None] if lid else np.zeros_like(fine)
        ids = ["L{:02d}_S{:07d}".format(lid, i) for i in range(n)]
        jstorage.save_scheduled_samples(lid, ids)
        jstorage.save_samples_bulk(lid, ids, fine, coarse)
        jstorage.save_n_ops([(lid, [float(2 ** lid) * n, float(n)])])
    return jstorage, mt.storage_from_jax(jstorage)


def _estimates(counts=COUNTS, n_moments=6, seed=0):
    """(mlmc_tpu Estimate, this package's Estimate, their bases) over the
    same samples."""
    import mlmc_tpu as jm
    import mlmc_tpu.estimator as jest
    from mlmc_tpu.quantity.quantity import make_root_quantity as j_root

    jstorage, tstorage = _stores(counts, seed)
    domain = (-4.0, 4.0)
    jq = j_root(jstorage, jstorage.load_result_format())["q"][0]["x"][0]
    tq = mt.make_root_quantity(tstorage, tstorage.load_result_format(),
                               device="cpu")["q"][0]["x"][0]
    jm_fn, tm_fn = jm.Legendre(n_moments, domain), mt.Legendre(n_moments, domain)
    return (jest.Estimate(jq, jstorage, jm_fn), mt.Estimate(tq, tstorage, tm_fn),
            jm_fn, tm_fn)


def _same_outcome(fn_a, fn_b):
    """Both calls pass (returning their values) or both raise
    AssertionError (returning None)."""
    outcomes = []
    for fn in (fn_a, fn_b):
        try:
            outcomes.append(("ok", fn()))
        except AssertionError:
            outcomes.append(("raised", None))
    assert outcomes[0][0] == outcomes[1][0], outcomes
    return outcomes


# --------------------------------------------------------------------- #
# stats_tests
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mu,var", [(2.0, 2.25), (3.0, 2.25), (2.0, 4.0)])
def test_stats_tests_decide_as_mlmc_tpu(mu, var):
    from mlmc_tpu.tool import stats_tests as jst

    samples = np.random.default_rng(0).normal(2.0, 1.5, size=5000)
    _same_outcome(lambda: jst.t_test(mu, samples), lambda: tst.t_test(mu, torch.tensor(samples)))
    _same_outcome(lambda: jst.chi2_test(var, samples),
                  lambda: tst.chi2_test(var, torch.tensor(samples)))
    rng = np.random.default_rng(1)
    for groups in ([rng.normal(0, 1, 200) for _ in range(4)],
                   [rng.normal(i * (mu - 2.0), 1, 200) for i in range(4)]):
        assert tst.anova(groups) == jst.anova(groups)
        assert tst.anova([torch.tensor(g) for g in groups]) == jst.anova(groups)
    with pytest.raises(AssertionError):
        tst.t_test(3.0, samples)


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def estimates():
    return _estimates()


def _exact_moments(mfn, h):
    import scipy.integrate as integrate
    import scipy.stats as st

    def fn(x, i):
        return mfn.eval_all_np(np.array([_qoi(x, h)]))[0, i] * st.norm.pdf(x)

    return np.array([integrate.quad(lambda x, i=i: fn(x, i), -6, 6)[0]
                     for i in range(mfn.size)])


def test_validate_moment_means_as_mlmc_tpu(estimates):
    from mlmc_tpu.tool import validation as jval

    jest, test, jm_fn, tm_fn = estimates
    exact = _exact_moments(tm_fn, STEPS[-1])
    np.testing.assert_allclose(exact, _exact_moments(jm_fn, STEPS[-1]), rtol=1e-12)
    (_, jres), (_, tres) = _same_outcome(
        lambda: jval.validate_moment_means(jest, jm_fn, exact),
        lambda: tval.validate_moment_means(test, tm_fn, exact))
    for a, b in zip(jres, tres):
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-14)
    wrong = exact + 0.05
    _same_outcome(lambda: jval.validate_moment_means(jest, jm_fn, wrong),
                  lambda: tval.validate_moment_means(test, tm_fn, wrong))


def test_validate_variance_regression_and_of_variance_as_mlmc_tpu(estimates):
    from mlmc_tpu.tool import validation as jval

    jest, test, jm_fn, tm_fn = estimates
    rms = [val.validate_variance_regression(e, COUNTS)
           for val, e in ((jval, jest), (tval, test))]
    np.testing.assert_allclose(rms[1], rms[0], rtol=1e-10)
    for n in (None, [200, 100, 50]):
        vv = [val.validate_variance_of_variance(e, n_samples=n)
              for val, e in ((jval, jest), (tval, test))]
        np.testing.assert_allclose(vv[1], vv[0], rtol=1e-10)


def test_validate_level_means_anova_as_mlmc_tpu(estimates):
    from mlmc_tpu.tool import validation as jval

    jest, test, jm_fn, tm_fn = estimates
    for alpha in (1e-4, 0.5):
        (outcome, jres), (_, tres) = _same_outcome(
            lambda: jval.validate_level_means_anova(jest, alpha=alpha),
            lambda: tval.validate_level_means_anova(test, alpha=alpha))
        if outcome == "ok":
            np.testing.assert_allclose(np.asarray(tres), np.asarray(jres), rtol=1e-10,
                                       atol=1e-14)


def test_validate_total_variance_as_mlmc_tpu():
    from mlmc_tpu.tool import validation as jval

    rng = np.random.default_rng(3)
    claimed = np.array([0.0, 0.01, 0.04])
    reps = rng.normal(0.0, np.sqrt(claimed), size=(40, 3))
    _same_outcome(lambda: jval.validate_total_variance(reps, claimed),
                  lambda: tval.validate_total_variance(torch.tensor(reps), claimed))
    _same_outcome(lambda: jval.validate_total_variance(reps * 10, claimed),
                  lambda: tval.validate_total_variance(reps * 10, claimed))


# --------------------------------------------------------------------- #
# the legacy maxent Distribution
# --------------------------------------------------------------------- #
def _two_gaussians(R):
    import scipy.stats as stats
    import mlmc_tpu.tool.simple_distribution as jsd

    comps = (stats.norm(-1.5, 0.6), stats.norm(2.0, 1.0))

    def pdf(x):
        return 0.5 * comps[0].pdf(x) + 0.5 * comps[1].pdf(x)

    lo = min(c.ppf(1e-6) for c in comps)
    hi = max(c.ppf(1 - 1e-6) for c in comps)
    import mlmc_tpu as jm

    mu = jsd.compute_semiexact_moments(jm.Legendre(R, (lo, hi), safe_eval=False), pdf,
                                       tol=1e-13)
    return pdf, (lo, hi), mu


@pytest.mark.parametrize("R", [5, 11])
def test_legacy_maxent_distribution_as_mlmc_tpu(R):
    import mlmc_tpu as jm
    from mlmc_tpu.tool.distribution import Distribution as JDist
    from mlmc_tpu_torch.tool.distribution import Distribution as TDist

    pdf, (lo, hi), mu = _two_gaussians(R)
    data = np.stack((mu, np.ones(R)), axis=1)
    dists = [cls(mfn, data, domain=(lo, hi), force_decay=(True, True))
             for cls, mfn in ((JDist, jm.Legendre(R, (lo, hi), safe_eval=False)),
                              (TDist, mt.Legendre(R, (lo, hi), safe_eval=False)))]
    res = [d.estimate_density_minimize(tol=1e-8) for d in dists]
    assert res[0].success and res[1].success and res[0].nit == res[1].nit
    np.testing.assert_allclose(res[1].x, res[0].x, rtol=1e-10, atol=1e-10)
    x = np.linspace(lo, hi, 41)
    np.testing.assert_allclose(dists[1].density(x), dists[0].density(x), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(dists[1].cdf(x[::5]), dists[0].cdf(x[::5]), rtol=1e-10,
                               atol=1e-14)
    sol = [d.estimate_density(tol=1e-10) for d in dists]
    np.testing.assert_allclose(sol[1].x, sol[0].x, rtol=1e-10, atol=1e-10)
    assert TDist.size_schedule(R) == JDist.size_schedule(R)


# --------------------------------------------------------------------- #
# config and profiling
# --------------------------------------------------------------------- #
def test_config_front_end_as_mlmc_tpu(tmp_path):
    from mlmc_tpu.tool import config as jcfg
    from mlmc_tpu_torch.tool import config as tcfg

    base = tmp_path / "base.yaml"
    base.write_text("sim:\n  sigma: 1.0\n  corr_length: 0.2\nlevels: 3\n")
    main = tmp_path / "main.yaml"
    main.write_text("include: base.yaml\nsim:\n  sigma: 0.5\ntarget_var: 1.0e-4\n")
    overrides = ["sim.corr_length=0.3", "levels=5", "sim.extra.deep=[1, 2]"]
    got = tcfg.load_config(str(main), overrides=overrides)
    assert got == jcfg.load_config(str(main), overrides=overrides)
    assert got["sim"] == {"sigma": 0.5, "corr_length": 0.3, "extra": {"deep": [1, 2]}}
    schema = {"sim": {"sigma": float, "corr_length": float}, "levels": int,
              "missing?": int, "target_var": lambda v: v > 0}
    assert tcfg.validate_config(got, schema) == jcfg.validate_config(got, schema) == []
    bad = {"nonexistent": int, "levels": str}
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError, match="nonexistent"):
            mod.validate_config(got, bad)
    cyc = tmp_path / "cyc.yaml"
    cyc.write_text("include: cyc.yaml\n")
    with pytest.raises(ValueError, match="cycle"):
        tcfg.load_config(str(cyc))
    with pytest.raises(ValueError, match="key.path=value"):
        tcfg.apply_overrides({}, ["novalue"])
    assert tcfg.deep_merge({"a": {"b": 1}}, {"a": {"c": 2}}) == {"a": {"b": 1, "c": 2}}


def test_profiling_helpers(tmp_path, capsys):
    from mlmc_tpu_torch.tool import profiling

    results = []
    with profiling.section_timer("matmul", results):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert results[0][0] == "matmul" and results[0][1] >= 0
    with profiling.stat_profiler():
        pass
    assert "[stat_profiler]" in capsys.readouterr().out
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32).sum()
    assert prof is not None
    files = sorted(os.listdir(tmp_path / "trace"))   # the trace, its counters
    assert len(files) == 2 and files[1].endswith(".json")
    assert files[0] == files[1][:-len(".json")] + ".counters.json"


# --------------------------------------------------------------------- #
# ProcessBase
# --------------------------------------------------------------------- #
def _processes():
    from mlmc_tpu import SynthSimulation as JSynth
    from mlmc_tpu.random.distributions import Norm as JNorm
    from mlmc_tpu.tool.process_base import ProcessBase as JProcess
    from mlmc_tpu_torch.tool.process_base import ProcessBase as TProcess

    class JaxSynth(JProcess):
        def create_simulation(self):
            return JSynth(dict(distr=JNorm(), complexity=2))

        def initial_n_samples(self):
            return [50, 10]

        def target_var(self):
            return 5e-2

    class TorchSynth(TProcess):
        def __init__(self, argv):
            self.device = "cpu"
            super().__init__(argv)

        def create_simulation(self):
            return mt.SynthSimulation(dict(distr=mt.Norm(), complexity=2))

        def initial_n_samples(self):
            return [50, 10]

        def target_var(self):
            return 5e-2

    return JaxSynth, TorchSynth


def test_process_reads_the_file_mlmc_tpu_ran(tmp_path):
    """mlmc_tpu's ``run`` writes mlmc_2.hdf5; this package's ``process``
    reads that file and its moments equal mlmc_tpu's ``process``."""
    pytest.importorskip("h5py")
    JaxSynth, TorchSynth = _processes()
    work_dir = str(tmp_path / "run")
    JaxSynth(argv=["run", work_dir, "--clean"])
    assert os.path.exists(os.path.join(work_dir, "mlmc_2.hdf5"))
    j_means, j_vars = JaxSynth(argv=["process", work_dir]).process()
    t_proc = TorchSynth(["process", work_dir])
    t_means, t_vars = t_proc.process()
    assert t_means[0] == 1.0 and t_proc.device == "cpu"
    np.testing.assert_allclose(t_means, np.asarray(j_means), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(t_vars, np.asarray(j_vars), rtol=1e-10, atol=1e-16)


def test_process_base_run_renew_collect_process(tmp_path):
    pytest.importorskip("h5py")
    _, TorchSynth = _processes()
    work_dir = str(tmp_path / "cli_run")
    p = TorchSynth(["run", work_dir, "--clean"])
    assert p.step_range == (1, 0.01) and p.n_levels == 2 and p.n_moments == 25
    assert os.path.exists(os.path.join(work_dir, "mlmc_2.hdf5"))
    means, variances = TorchSynth(["process", work_dir]).process()
    assert means[0] == 1.0 and np.all(np.isfinite(variances))
    TorchSynth(["renew", work_dir])
    TorchSynth(["collect", work_dir])
    again, _ = TorchSynth(["process", work_dir]).process()
    np.testing.assert_array_equal(again, means)
    args = mt.tool.process_base.ProcessBase.get_arguments(["run", "w", "-c", "-d"])
    assert args.clean and args.debug and args.command == "run"


def test_process_base_analysis_recipes(tmp_path, estimates):
    """The analysis recipes over this package's estimate; the convergence
    rates equal mlmc_tpu's recipe on the same samples."""
    from mlmc_tpu.tool.process_base import ProcessBase as JProcess
    from mlmc_tpu_torch.tool.process_base import ProcessBase as TProcess

    jest, test, jm_fn, tm_fn = estimates
    pb = TProcess.__new__(TProcess)
    rates, extrap = pb.analyze_convergence_rates(test)
    j_rates, j_extrap = JProcess.__new__(JProcess).analyze_convergence_rates(jest)
    for k in ("alpha", "beta", "gamma"):
        np.testing.assert_allclose(rates[k], j_rates[k], rtol=1e-10)
    np.testing.assert_allclose(extrap, j_extrap, rtol=1e-10)
    reg = pb.analyze_regression_of_variance(test, None, out_file=str(tmp_path / "reg"))
    assert np.all(np.isfinite(reg)) and reg.shape[1] == tm_fn.size
    out = {
        "lvl": pb.analyze_error_of_level_variances(test, None, out_file=str(tmp_path / "lvl")),
        "var": pb.analyze_error_of_variance(test, None, out_file=str(tmp_path / "var")),
        "regv": pb.analyze_error_of_regression_variance(
            test, None, out_file=str(tmp_path / "regv"), n_subsamples=6),
        "reglv": pb.analyze_error_of_regression_level_variances(
            test, None, out_file=str(tmp_path / "reglv"), n_subsamples=4),
        "logv": pb.analyze_error_of_log_variance(test, None, out_file=str(tmp_path / "logv"),
                                                 n_subsamples=6)}
    for name, values in out.items():
        assert np.all(np.isfinite(values)), name
        assert (tmp_path / (name + ".pdf")).exists(), name
    distr, result = pb.analyze_pdf_approx(test, out_file=str(tmp_path / "pdf"), tol=1e-6)
    assert result.success and (tmp_path / "pdf.pdf").exists()
    assert pb.set_moments(test.quantity, test._sample_storage, n_moments=4).size == 4


# --------------------------------------------------------------------- #
# plots
# --------------------------------------------------------------------- #
def test_plots_render_tensors(tmp_path, estimates):
    import scipy.stats as stats
    from mlmc_tpu_torch.plot import plots

    jest, test, jm_fn, tm_fn = estimates
    l_vars, n_samples = test.estimate_diff_vars(tm_fn)
    distr_obj, info, result, _ = test.construct_density(tol=1e-6)
    dp = plots.Distribution(exact_distr=stats.norm(), title="test", error_plot="kl")
    dp.add_distribution(distr_obj)
    dp.add_raw_samples(test.get_level_samples(level_id=0)[0, :, 0])     # a tensor
    dp.show(file=str(tmp_path / "distribution"))
    ev = plots.Eigenvalues(title="eigs")
    ev.add_values(torch.tensor(np.asarray(info[0])), threshold=info[1], label="spectrum")
    ev.add_linear_fit(np.abs(info[0]))
    ev.show(file=str(tmp_path / "eigs"))
    plots.moments(tm_fn, title="moments", file=str(tmp_path / "moments"))
    vb = plots.VarianceBreakdown()
    vb.add_variances(torch.tensor(l_vars), n_samples, ref_level_vars=l_vars)
    vb.show(file=str(tmp_path / "varbreak"))
    var_plot = plots.Variance()
    var_plot.add_level_variances(torch.tensor(STEPS), l_vars)
    var_plot.show(file=str(tmp_path / "vars"))
    test.est_bootstrap(n_subsamples=8, sample_vector=[1000, 250, 50])
    bs = plots.BSplots(n_samples=COUNTS, bs_n_samples=[1000, 250, 50], n_moments=6,
                       ref_level_var=torch.tensor(l_vars))
    bs.plot_bootstrap_variance_compare(test.mean_bs_l_vars, file=str(tmp_path / "bscmp"))
    bs.plot_means_and_vars(test.mean_bs_mean, test.var_bs_mean, 3, file=str(tmp_path / "bsmv"))
    bs.plot_var_regression(test, 3, tm_fn, file=str(tmp_path / "bsreg"))
    plots.plot_vars(test.mean_bs_mean, test.var_bs_mean, 3, file=str(tmp_path / "pv"))
    plots.plot_diff_var(l_vars, 6, STEPS, file=str(tmp_path / "pdv"))
    plots.plot_diff_var_subsample(torch.rand(3, 5), 2, file=str(tmp_path / "dvs"))
    plots.plot_error(torch.randn(100), file=str(tmp_path / "err"))
    plots.plot_regression_diffs(np.abs(np.random.default_rng(0).normal(size=(4, 3))), 5,
                                file=str(tmp_path / "rd"))
    plots.plot_level_costs([[0.1], [0.05], [0.025]], torch.tensor([0.01, 0.05, 0.3]),
                           n_elements=[100, 400, 1600], file=str(tmp_path / "costs.pdf"))
    plots.plot_convergence([0.1, 0.2], np.abs(np.random.default_rng(1).normal(size=(2, 5))),
                           "conv", file=str(tmp_path / "conv"))
    plots.plot_mlmc_conv(6, [1e-3, 1e-4], np.zeros(6), np.full((2, 6), 0.01), [1e-3, 1e-4],
                         file=str(tmp_path / "mlmcconv"))
    plots.plot_n_sample_est_distributions("nse", np.arange(10.0), np.arange(10.0),
                                          np.arange(10.0), file=str(tmp_path / "nse"))
    for f in ("distribution", "eigs", "moments", "varbreak", "vars", "bscmp", "bsmv",
              "bsreg", "pv", "pdv", "dvs", "err", "rd", "costs", "conv", "mlmcconv", "nse"):
        assert (tmp_path / (f + ".pdf")).exists(), f
    assert plots.plot_pbs_flow_job_time is plots.plot_level_costs


def test_estimate_plot_helpers(tmp_path, monkeypatch, estimates):
    """``Estimate.plot_variances`` (saves under its title in the working
    directory, as mlmc_tpu's) and ``plot_bs_var_log``."""
    jest, test, jm_fn, tm_fn = estimates
    monkeypatch.chdir(tmp_path)
    test.plot_variances(sample_vec=[1000, 250, 50])
    assert (tmp_path / "Variance breakdown.pdf").exists()
    bs_plot = test.plot_bs_var_log(sample_vec=[1000, 250, 50])
    assert bs_plot._n_moments == 6 and np.all(np.isfinite(test.var_bs_l_vars))


def test_violinplot(tmp_path, monkeypatch, estimates):
    pytest.importorskip("seaborn")
    pytest.importorskip("pandas")
    monkeypatch.chdir(tmp_path)          # the estimate's plot saves under its name
    from mlmc_tpu_torch.plot import violinplot

    jest, test, jm_fn, tm_fn = estimates
    vp = violinplot.ViolinPlotter()
    rng = np.random.default_rng(1)
    vp.add_level("0 F  1 C", torch.tensor(rng.normal(size=50)), rng.normal(size=50))
    vp.show(file=str(tmp_path / "vp.pdf"))
    violinplot.violinplot(rng.normal(size=80), file=str(tmp_path / "v1.pdf"))
    assert (tmp_path / "vp.pdf").exists() and (tmp_path / "v1.pdf").exists()
    test.fine_coarse_violinplot()
    assert (tmp_path / "violinplot.pdf").exists()
