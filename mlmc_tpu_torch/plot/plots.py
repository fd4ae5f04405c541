"""Host-side matplotlib diagnostics (counterpart of
``mlmc_tpu/plot/plots.py``).

Re-design of reference mlmc/plot/plots.py:81-1266 with the same public
surface: ``Distribution`` (pdf/cdf vs exact), ``Eigenvalues``,
``moments`` (basis functions), ``VarianceBreakdown``, ``Variance``
(level variances vs step), ``BSplots`` (bootstrap diagnostics), and the
module-level convergence/cost plots. Figures are produced headlessly
(Agg) and ``show(file)`` saves to file when given, else displays. Data
may be numpy arrays or tensors on any device.
"""
import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import matplotlib.cm as cm  # noqa: E402
import matplotlib.colors as mcolors  # noqa: E402
from matplotlib.ticker import FormatStrFormatter  # noqa: E402

from mlmc_tpu_torch.ops.precision import _np  # noqa: E402


def _host(values, dtype=None):
    """Plot data (a tensor on any device, or array-like) as a numpy array."""
    return np.asarray(_np(values), dtype=dtype)


def create_color_bar(range_, label, ax=None):
    """Log-scaled colorbar for moment indices (reference plots.py:11-38)."""
    colormap = cm.viridis
    normalize = mcolors.LogNorm(vmin=1, vmax=max(range_, 2))
    scalar_mappable = cm.ScalarMappable(norm=normalize, cmap=colormap)
    scalar_mappable.set_array(np.arange(range_))
    if ax is not None:
        clb = plt.colorbar(scalar_mappable, ax=ax)
        clb.set_label(label)
    return lambda v: colormap(normalize(max(v, 1)))


def moments_subset(n_moments, moments=None):
    """Subset of moment indices to plot (reference plots.py:40-57)."""
    if moments is None:
        return np.arange(1, n_moments)
    return np.round(np.geomspace(1, n_moments - 1, moments)).astype(int)


def _show_and_save(fig, file, title):
    """Save to ``file`` (default name = title when file is None); with
    file == "" the figure is just closed — the module forces the headless
    Agg backend, where fig.show() can never display and leaving figures
    open accumulates memory."""
    if file is None:
        file = title
    if file == "":
        plt.close(fig)
        return
    if not str(file).endswith(".pdf") and not str(file).endswith(".png"):
        file = "{}.pdf".format(file)
    fig.savefig(file)
    plt.close(fig)


def make_monotone(X, Y):
    """Sort X and drop duplicate abscissae so (X, Y) is strictly monotone."""
    sX, iX = np.unique(X, return_index=True)
    return sX, np.array(Y)[iX]


class Distribution:
    """PDF/CDF plot of reconstructed densities vs exact (reference :81-290)."""

    def __init__(self, exact_distr=None, title="", quantity_name="X",
                 legend_title="", log_density=False, cdf_plot=True,
                 log_x=False, error_plot="l2"):
        self._exact_distr = exact_distr
        self._title = title
        self._legend_title = legend_title
        self._log_density = log_density
        self._log_x = log_x
        self._error_plot = error_plot
        self._domain = None
        self.plot_matrix = []
        self.i_plot = 0

        # one figure with pdf+cdf side by side, or two separate figures
        if cdf_plot:
            self.fig, (self.ax_pdf, self.ax_cdf) = plt.subplots(
                1, 2, figsize=(22, 10))
            self.fig_cdf = None
        else:
            self.fig, self.ax_pdf = plt.subplots(figsize=(12, 10))
            self.fig_cdf, self.ax_cdf = plt.subplots(figsize=(12, 10))
        self.fig.suptitle(title)

        x_label = ("log " if log_x else "") + quantity_name
        for ax, what, y_label in ((self.ax_pdf, "PDF",
                                   "probability density"),
                                  (self.ax_cdf, "CDF", "probability")):
            ax.set_title("{} approximations".format(what))
            ax.set_xlabel(x_label)
            ax.set_ylabel(y_label)
            if log_x:
                ax.set_xscale("log")
        if log_density:
            self.ax_pdf.set_yscale("log")

        # dashed error curves on twin axes (reference :141-157): 'kl' plots
        # the KL integrand exact*log(exact/approx) - exact + approx, anything
        # else the plain difference; CDF error is always the difference
        self.ax_pdf_err = self.ax_cdf_err = None
        if error_plot:
            pdf_err_label = ("KL-error - dashed" if error_plot == "kl"
                             else "error - dashed")
            self.ax_pdf_err = self._error_twin(self.ax_pdf, pdf_err_label)
            self.ax_cdf_err = self._error_twin(self.ax_cdf,
                                               "error - dashed")

    @staticmethod
    def _error_twin(ax, label):
        """Log-scaled twin y-axis for the dashed error curve; the primary
        axis is lifted above it so data lines stay on top."""
        twin = ax.twinx()
        ax.set_zorder(10)
        ax.patch.set_visible(False)
        twin.set_ylabel(label)
        twin.set_yscale("log")
        return twin

    def add_raw_samples(self, samples):
        """Histogram + rug of raw samples (reference :158-183)."""
        samples = _host(samples)
        samples = samples[~np.isnan(samples)]
        # widen the plot domain to cover the samples (reference :163-165);
        # also makes add_raw_samples callable before any add_distribution
        self.adjust_domain((float(samples.min()), float(samples.max())))
        bins = self._grid(int(0.5 * np.sqrt(len(samples))))
        self.ax_pdf.hist(samples, density=True, bins=bins, alpha=0.3,
                         label="samples", color="red")
        X = samples[:min(len(samples), 1000)]
        self.ax_pdf.plot(X, -0.02 * np.ones_like(X), "k|", ms=10)

    def add_distribution(self, distr_object, label=None):
        """Add a maxent-reconstructed density (reference :185-223)."""
        if label is None:
            label = "size {}".format(distr_object.moments_fn.size)
        domain = distr_object.domain
        self.adjust_domain(domain)
        d_size = domain[1] - domain[0]
        slack = 0.05
        extended = (domain[0] - slack * d_size, domain[1] + slack * d_size)
        X = self._grid(1000, domain=extended)
        color = "C{}".format(self.i_plot % 10)

        plots = []
        Y_pdf = _host(distr_object.density(X))
        self.ax_pdf.plot(X, Y_pdf, label=label, color=color)
        self._plot_borders(self.ax_pdf, color, domain)

        Y_cdf = _host(distr_object.cdf(X))
        self.ax_cdf.plot(X, Y_cdf, color=color)
        self._plot_borders(self.ax_cdf, color, domain)

        if self.ax_pdf_err is not None and self._exact_distr is not None:
            exact_pdf = self._exact_distr.pdf(X)
            if self._error_plot == "kl":
                with np.errstate(divide="ignore", invalid="ignore"):
                    eY_pdf = (exact_pdf * np.log(exact_pdf / Y_pdf)
                              - exact_pdf + Y_pdf)
            else:
                eY_pdf = Y_pdf - exact_pdf
            self.ax_pdf_err.plot(X, eY_pdf, linestyle="--", color=color,
                                 linewidth=0.5)
            eY_cdf = Y_cdf - self._exact_distr.cdf(X)
            self.ax_cdf_err.plot(X, eY_cdf, linestyle="--", color=color,
                                 linewidth=0.5)

        self.i_plot += 1
        return plots

    def show(self, file=""):
        self._add_exact_distr()
        self.ax_pdf.legend(title=self._legend_title)
        _show_and_save(self.fig, file, self._title)
        if self.fig_cdf is not None:
            # a concrete file name must not be overwritten by the CDF figure
            cdf_file = file
            if file:
                stem = str(file)
                for ext in (".pdf", ".png"):
                    if stem.endswith(ext):
                        stem = stem[: -len(ext)]
                        break
                cdf_file = stem + "_cdf"
            _show_and_save(self.fig_cdf, cdf_file, self._title + "_cdf")

    def reset(self):
        """Clear accumulated curves for a fresh plot."""
        plt.close()
        self._domain = None

    def _plot_borders(self, ax, color, domain=None):
        """Short vertical ticks marking the approximation domain ends."""
        lo, hi = self._domain if domain is None else domain
        return [ax.axvline(x=edge, ymin=0, ymax=0.1, color=color)
                for edge in (lo, hi)]

    def adjust_domain(self, domain):
        """Widen the x-domain to cover ``domain``."""
        if self._domain is None:
            self._domain = list(domain)
        else:
            self._domain[0] = min(self._domain[0], domain[0])
            self._domain[1] = max(self._domain[1], domain[1])

    def _add_exact_distr(self):
        if self._exact_distr is None:
            return
        X = self._grid(1000)
        Y = self._exact_distr.pdf(X)
        self.ax_pdf.plot(X, Y, c="black", label="exact")
        Y = self._exact_distr.cdf(X)
        self.ax_cdf.plot(X, Y, c="black")

    def _grid(self, size, domain=None):
        """Evaluation grid over the plot domain (geometric under log_x)."""
        lo, hi = self._domain if domain is None else domain
        if self._log_x:
            return np.geomspace(max(lo, 1e-30), hi, size)
        return np.linspace(lo, hi, size)


class Eigenvalues:
    """Eigenvalue spectra of covariance matrices (reference :292-366)."""

    def __init__(self, log_y=True, title="Eigenvalues"):
        self._ylim = None
        self.log_y = log_y
        self.fig = plt.figure(figsize=(13, 10))
        self.ax = self.fig.add_subplot(1, 1, 1)
        self.title = title
        self.ax.set_xlabel("eigenvalue index")
        self.ax.set_ylabel("eigenvalue magnitude")
        if log_y:
            self.ax.set_yscale("log")
        self.i_plot = 0

    def add_values(self, values, errors=None, threshold=None, label=""):
        """Plot one sorted spectrum with optional errors + threshold mark."""
        values = _host(values)
        if values[0] < values[-1]:
            values = np.flip(values)
            if errors is not None:
                errors = np.flip(_host(errors))
            if threshold is not None:
                threshold = len(values) - 1 - threshold
        X = np.arange(len(values))
        color = "C{}".format(self.i_plot % 10)
        if self.log_y:
            values = np.maximum(values, 1e-30)
        if errors is None:
            self.ax.scatter(X, values, label=label, color=color, s=12)
        else:
            self.ax.errorbar(X, values, yerr=errors, fmt="o", label=label,
                             color=color, ms=4)
        if threshold is not None:
            self.ax.axvline(x=threshold - 0.1, color=color, ls=":")
        self.i_plot += 1

    def add_linear_fit(self, values):
        """Overlay a least-squares linear fit of the log-eigenvalues."""
        values = _host(values)
        X = np.arange(len(values))
        pos = values > 0
        fit = np.polyfit(X[pos], np.log(values[pos]), deg=1)
        self.ax.plot(X, np.exp(np.poly1d(fit)(X)), "k--", lw=0.8)

    def show(self, file=""):
        self.ax.legend()
        _show_and_save(self.fig, file, self.title)

    def adjust_ylim(self, ylim):
        """Widen the y-limits to cover ``ylim``."""
        if self._ylim is None:
            self._ylim = list(ylim)
        else:
            self._ylim[0] = min(self._ylim[0], ylim[0])
            self._ylim[1] = max(self._ylim[1], ylim[1])


def moments(moments_fn, size=None, title="", file=""):
    """Plot moment basis functions over the domain (reference :369-393)."""
    if size is None:
        size = max(moments_fn.size, 21)
    fig = plt.figure(figsize=(13, 10))
    ax = fig.add_subplot(1, 1, 1)
    cmap = create_color_bar(size, "moments", ax)
    n_pt = 1000
    X = np.linspace(moments_fn.domain[0] + 1e-10, moments_fn.domain[1] - 1e-10, n_pt)
    Y = _host(moments_fn.eval_all_np(X, size=size))
    central_band = Y[int(n_pt * 0.1):int(n_pt * 0.9), :]
    ax.set_ylim((np.min(central_band), np.max(central_band)))
    for m in range(1, size):
        ax.plot(X, Y[:, m], color=cmap(m), linewidth=0.5)
    _show_and_save(fig, file, title)


class VarianceBreakdown:
    """Per-moment variance contributions by level (reference :395-485)."""

    def __init__(self, moments=None):
        self.fig = plt.figure(figsize=(15, 8))
        self.title = "Variance breakdown"
        self.fig.suptitle(self.title)
        self.ax = self.fig.add_subplot(1, 1, 1)
        self.X_list = []
        self.X_labels = []
        self.x_shift = 0
        self.n_moments = None
        self.subset_type = moments

    def add_variances(self, level_vars, n_samples, ref_level_vars=None):
        """:param level_vars: [L, R] variances V_l,r
        :param n_samples: [L]
        :param ref_level_vars: optional reference (e.g. bootstrap) variances
        """
        level_vars = _host(level_vars)
        n_levels, n_moments = level_vars.shape
        if self.n_moments is None:
            self.n_moments = n_moments
            self.i_moments = moments_subset(n_moments, self.subset_type)
        width = 0.8
        X = self.x_shift + (width + 0.2) * np.arange(len(self.i_moments))
        self.x_shift = X[-1] + 1.5 if len(X) else self.x_shift + 1.5
        self.X_list.extend(X.tolist())
        self.X_labels.extend([str(m) for m in self.i_moments])

        vars_ = level_vars[:, self.i_moments]
        n_samples = _host(n_samples)[:, None]
        contributions = vars_ / n_samples
        total = np.sum(contributions, axis=0)
        first_group = len(self.X_labels) == len(self.i_moments)
        bottom = np.zeros_like(X, dtype=float)
        for lvl in range(n_levels):
            frac = contributions[lvl] / total
            self.ax.bar(X, frac, width, bottom=bottom,
                        label="level {}".format(lvl) if first_group else None,
                        color=cm.tab20(lvl % 20))
            bottom += frac
        if ref_level_vars is not None:
            ref = np.sum(_host(ref_level_vars)[:, self.i_moments] / n_samples,
                         axis=0)
            self.ax.plot(X, ref / total, "k_", ms=12)

    def show(self, file=""):
        self.ax.set_xticks(self.X_list)
        self.ax.set_xticklabels(self.X_labels)
        self.ax.set_xlabel("moment index")
        self.ax.set_ylabel("variance fraction by level")
        self.ax.legend()
        _show_and_save(self.fig, file, self.title)


class Variance:
    """Level diff-variances vs simulation step (reference :487-555)."""

    def __init__(self, moments=None):
        self.fig = plt.figure(figsize=(15, 8))
        self.title = "Level variances"
        self.fig.suptitle(self.title)
        self.ax = self.fig.add_subplot(1, 1, 1)
        self.ax.set_xlabel("simulation step h")
        self.ax.set_ylabel("level diff variance V_l")
        self.ax.set_xscale("log")
        self.ax.set_yscale("log")
        self.subset_type = moments
        self._cmap = None

    def add_level_variances(self, steps, variances):
        """:param steps: [L]; :param variances: [L, R]"""
        steps = np.squeeze(_host(steps, dtype=float))
        steps = np.atleast_1d(steps)
        variances = _host(variances)
        n_moments = variances.shape[1]
        i_moments = moments_subset(n_moments, self.subset_type)
        if self._cmap is None:
            # one colorbar for the figure's lifetime: repeated adds (one
            # per MLMC instance) must not stack duplicates
            self._cmap = create_color_bar(n_moments, "moments", self.ax)
        for m in i_moments:
            self.ax.plot(steps, np.maximum(variances[:, m], 1e-30), "o-",
                         color=self._cmap(m), linewidth=0.6, ms=3)

    def show(self, file=""):
        _show_and_save(self.fig, file, self.title)


class BSplots:
    """Bootstrap diagnostics (reference :557-809)."""

    def __init__(self, n_samples, bs_n_samples, n_moments, ref_level_var):
        self._bs_n_samples = _host(bs_n_samples)
        self._n_moments = n_moments
        self._ref_level_var = _host(ref_level_var) \
            if ref_level_var is not None else None
        self._n_levels = len(np.atleast_1d(n_samples))
        self.fig = None
        self._moments_cmap = None

    def set_moments_color_bar(self, range_, label, ax=None):
        """Attach the moment-index color bar used by the BS plots."""
        self._moments_cmap = create_color_bar(range_, label, ax)
        return self._moments_cmap

    def _cmap(self, m):
        if self._moments_cmap is None:
            self._moments_cmap = create_color_bar(self._n_moments, "moments")
        return self._moments_cmap(m)

    def _scatter_level_moment_data(self, ax, values, i_moments=None, marker="o"):
        """values: [n_levels, n_moments]-shaped data scattered by level."""
        values = _host(values)
        if i_moments is None:
            i_moments = range(values.shape[1])
        for lvl in range(values.shape[0]):
            for im, m in enumerate(i_moments):
                ax.scatter(lvl + 0.1 * im / max(len(list(i_moments)), 1),
                           values[lvl, m], color=self._cmap(m),
                           marker=marker, s=12)

    def plot_bootstrap_variance_compare(self, bs_level_vars=None, file=""):
        """BS-estimated level variances vs reference (reference :618-651)."""
        fig, ax = plt.subplots(figsize=(12, 8))
        ax.set_yscale("log")
        ax.set_xlabel("level")
        ax.set_ylabel("var")
        if self._ref_level_var is not None:
            self._scatter_level_moment_data(ax, np.maximum(self._ref_level_var, 1e-30),
                                            marker="_")
        if bs_level_vars is not None:
            self._scatter_level_moment_data(ax, np.maximum(bs_level_vars, 1e-30),
                                            marker="o")
        _show_and_save(fig, file, "bs_variance_compare")

    def plot_bs_variances(self, variances, y_label=None, log=True, y_lim=None,
                          file=""):
        """Generic grid of BS variance plots (reference :653-679)."""
        fig, ax = plt.subplots(figsize=(12, 8))
        if log:
            ax.set_yscale("log")
        if y_lim is not None:
            ax.set_ylim(y_lim)
        if y_label is not None:
            ax.set_ylabel(y_label)
        ax.set_xlabel("level")
        self._scatter_level_moment_data(ax, np.maximum(_host(variances), 1e-30))
        _show_and_save(fig, file, "bs_variances")

    def plot_bs_var_error_contributions(self, bs_var_l_means=None, file=""):
        """Per-level contributions to total variance error (reference :681-692)."""
        if bs_var_l_means is None:
            return
        contribs = _host(bs_var_l_means) * self._bs_n_samples[:, None]
        self.plot_bs_variances(contribs,
                               y_label="contributions to total variance",
                               file=file)

    def plot_bs_level_variances_error(self, l_vars=None, file=""):
        if l_vars is None:
            return
        self.plot_bs_variances(l_vars, y_label="level variances", file=file)

    def plot_bs_var_log_var(self, bs_var_vars=None, file=""):
        if bs_var_vars is None:
            return
        self.plot_bs_variances(bs_var_vars, y_label="var of var estimate",
                               file=file)

    def plot_means_and_vars(self, moments_mean, moments_var, n_levels,
                            exact_moments=None, file=""):
        """Moment estimates with errorbars vs exact (reference :738-762)."""
        moments_mean = _host(moments_mean)
        moments_var = _host(moments_var)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(18, 8))
        X = np.arange(len(moments_mean))
        ax1.errorbar(X, moments_mean, yerr=3 * np.sqrt(np.maximum(moments_var, 0)),
                     fmt="o", capsize=3, label="estimate")
        if exact_moments is not None:
            ax1.plot(X, exact_moments, "k_", ms=14, label="exact")
        ax1.set_xlabel("moment")
        ax1.set_ylabel("moment mean +- 3 sigma")
        ax1.legend()
        ax2.set_yscale("log")
        ax2.plot(X[1:], np.maximum(moments_var[1:], 1e-30), "o")
        ax2.set_xlabel("moment")
        ax2.set_ylabel("estimate variance")
        _show_and_save(fig, file, "means_and_vars")

    def plot_var_regression(self, estimator, n_levels, moments_fn,
                            i_moments=None, file=""):
        """Raw vs regression-smoothed level variances (reference :764-807)."""
        fig, ax = plt.subplots(figsize=(12, 8))
        ax.set_yscale("log")
        ax.set_xlabel("level")
        ax.set_ylabel("level diff var")
        raw_vars, n_samples = estimator.estimate_diff_vars(moments_fn)
        reg_vars, _ = estimator.estimate_diff_vars_regression(
            n_samples, moments_fn)
        if i_moments is None:
            i_moments = moments_subset(moments_fn.size, 5)
        for m in i_moments:
            color = self._cmap(m)
            ax.plot(np.arange(n_levels), np.maximum(raw_vars[:, m], 1e-30),
                    "o", color=color)
            ax.plot(np.arange(n_levels), np.maximum(reg_vars[:, m], 1e-30),
                    "-", color=color, lw=0.7)
        _show_and_save(fig, file, "var_regression")


# ------------------------------------------------------------------ #
# module-level convergence / cost plots
# ------------------------------------------------------------------ #
def plot_n_sample_est_distributions(title, cost, total_std, n_samples,
                                    rel_moments=None, file=""):
    """Histograms of bootstrap cost / std / n_samples (reference :1251-1266)."""
    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    fig.suptitle(title)
    axes[0].hist(_host(cost).ravel(), bins=30)
    axes[0].set_xlabel("cost")
    axes[1].hist(_host(total_std).ravel(), bins=30)
    axes[1].set_xlabel("total std")
    axes[2].hist(_host(n_samples).ravel(), bins=30)
    axes[2].set_xlabel("n samples")
    _show_and_save(fig, file, title)


def plot_vars(moments_mean, moments_var, n_levels, exact_moments=None,
              ex_moments=None, file=""):
    """Moment means with CIs vs exact (reference :1098-1127)."""
    moments_mean = _host(moments_mean)
    moments_var = _host(moments_var)
    fig, ax = plt.subplots(figsize=(12, 8))
    X = np.arange(len(moments_mean))
    ax.errorbar(X, moments_mean, yerr=3 * np.sqrt(np.maximum(moments_var, 0)),
                fmt="o", capsize=3, label="estimate ({} levels)".format(n_levels))
    if exact_moments is not None:
        ax.plot(X, exact_moments, "k_", ms=14, label="exact")
    ax.set_xlabel("moment")
    ax.legend()
    _show_and_save(fig, file, "moment_vars")


def plot_convergence(quantiles, conv_val, title, file=""):
    """Convergence vs quantile parameter (reference :1129-1153)."""
    fig, ax = plt.subplots(figsize=(10, 7))
    conv_val = _host(conv_val)
    for iq, q in enumerate(np.atleast_1d(quantiles)):
        ax.plot(np.arange(conv_val.shape[-1]), np.atleast_2d(conv_val)[iq],
                "o-", label="q={}".format(q))
    ax.set_yscale("log")
    ax.set_title(title)
    ax.legend()
    _show_and_save(fig, file, title)


def plot_diff_var(ref_mc_diff_vars, n_moments, steps, file=""):
    """Level diff variances vs step per moment (reference :1156-1185)."""
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.set_xscale("log")
    ax.set_yscale("log")
    cmap = create_color_bar(n_moments, "moments", ax)
    ref_mc_diff_vars = _host(ref_mc_diff_vars)
    for m in range(1, n_moments):
        ax.plot(steps, np.maximum(ref_mc_diff_vars[:, m], 1e-30), "o-",
                color=cmap(m), lw=0.6, ms=3)
    ax.set_xlabel("step h")
    ax.set_ylabel("level diff var")
    _show_and_save(fig, file, "diff_vars")


def plot_var_regression(ref_level_vars, reg_vars, n_levels, n_moments, file=""):
    """Raw vs regression variances by level (reference :1188-1204)."""
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.set_yscale("log")
    cmap = create_color_bar(n_moments, "moments", ax)
    X = np.arange(n_levels)
    for m in range(1, n_moments):
        ax.plot(X, np.maximum(_host(ref_level_vars)[:, m], 1e-30), "o",
                color=cmap(m), ms=3)
        ax.plot(X, np.maximum(_host(reg_vars)[:, m], 1e-30), "-",
                color=cmap(m), lw=0.6)
    _show_and_save(fig, file, "var_regression")


def plot_mlmc_conv(n_moments, vars_est, exact_mean, means_est, target_var,
                   file=""):
    """Estimate error vs target variance (reference :1227-1248)."""
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.set_xscale("log")
    ax.set_yscale("log")
    vars_est = _host(vars_est)
    means_est = _host(means_est)
    exact_mean = _host(exact_mean)
    for m in range(1, min(n_moments, means_est.shape[-1])):
        err = np.abs(means_est[..., m] - exact_mean[m])
        ax.plot(np.atleast_1d(target_var), np.atleast_1d(err), "o-",
                label="moment {}".format(m))
    ax.plot(np.atleast_1d(target_var), np.sqrt(np.atleast_1d(target_var)),
            "k--", label="sqrt(target var)")
    ax.set_xlabel("target variance")
    ax.set_ylabel("|error|")
    ax.legend()
    _show_and_save(fig, file, "mlmc_conv")


def plot_diff_var_subsample(level_variance_diff, n_levels, file=""):
    """Subsampled level-variance differences (reference :1066-1095)."""
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.set_yscale("log")
    level_variance_diff = np.atleast_2d(_host(level_variance_diff))
    X = np.arange(level_variance_diff.shape[-1])
    for i, diff in enumerate(level_variance_diff):
        ax.plot(X, np.maximum(np.abs(diff), 1e-30), "o-",
                label="subsample {}".format(i), lw=0.7, ms=3)
    ax.set_xlabel("moment")
    ax.set_ylabel("|level variance difference|")
    ax.legend()
    _show_and_save(fig, file, "diff_var_subsample")


def plot_error(errors, file="", title="errors"):
    """Histogram of estimate errors (reference plot_error)."""
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.hist(_host(errors).ravel(), bins=40)
    ax.set_xlabel("error")
    ax.set_ylabel("count")
    _show_and_save(fig, file, title)


def plot_regression_diffs(all_diffs, n_moments, file=""):
    """Regression-vs-raw variance differences per moment (reference :1207-1224)."""
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.set_yscale("log")
    cmap = create_color_bar(n_moments, "moments", ax)
    for m, diffs in enumerate(np.atleast_2d(_host(all_diffs))):
        ax.plot(np.arange(len(diffs)), np.maximum(np.abs(diffs), 1e-30),
                "o-", color=cmap(m + 1), lw=0.6, ms=3)
    ax.set_xlabel("level")
    ax.set_ylabel("|regression - raw|")
    _show_and_save(fig, file, "regression_diffs")


def plot_level_costs(level_params, n_ops, n_elements=None, file="",
                     title="level costs"):
    """Per-level sample cost vs problem size.

    Generalization of the reference's plot_pbs_flow_job_time
    (reference plots.py:1285-1313), which hardcodes a personal results
    directory: here the caller passes level parameters + measured n_ops
    (``storage.get_level_parameters()`` / ``storage.get_n_ops()``) and
    optionally per-level element counts for the tick labels.
    """
    level_params = np.squeeze(_host(level_params, dtype=float))
    n_ops = _host(n_ops, dtype=float)
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.set_xscale("log")
    ax.set_yscale("log")
    x = 1.0 / (level_params ** 2)
    ax.plot(x, n_ops, "o-")
    if n_elements is not None:
        ax.set_xticks(x)
        ax.set_xticklabels(["{}".format(int(n)) for n in n_elements])
        ax.set_xlabel("mesh elements")
    else:
        ax.set_xlabel(r"problem size $1/h_l^2$")
    ax.set_ylabel("cost per sample [s]")
    _show_and_save(fig, file, title)


# reference-surface alias (the reference function reads a hardcoded PBS
# results directory; pass your own storage-derived values instead)
plot_pbs_flow_job_time = plot_level_costs
