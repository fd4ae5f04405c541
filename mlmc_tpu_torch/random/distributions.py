"""Sampling distributions driven by explicit ``torch.Generator``s.

Counterpart of ``mlmc_tpu/random/distributions.py``. Each distribution is
a small frozen spec with ``sample(generator, shape, device)`` (tensor code
on the generator's device), ``from_standard_normals`` for the counter-based
draws, ``sample_uniforms`` (inverse-transform sampling of given uniforms,
the quasi-Monte Carlo entry) and host helpers through scipy (``rvs``,
``ppf``, ``pdf``, ``cdf``, ``mean``, ``var``) for domain estimation and
exact-moment checks.
"""
import dataclasses

import numpy as np
import torch


class TorchDistr:
    """Base: generator-driven sampler with scipy-compatible helpers."""

    #: uniforms consumed per variate by ``sample_uniforms`` (QMC dimension)
    qmc_dim = 1

    def sample(self, generator, shape=(), device=None, dtype=torch.float64):
        """Draw variates of ``shape`` from ``generator`` on ``device``
        (the generator must live on the same device)."""
        raise NotImplementedError

    def from_standard_normals(self, z):
        """Variates from standard normals ``z`` (counter-based draws)."""
        raise NotImplementedError(
            "{} has no map from standard normals".format(type(self).__name__))

    def sample_uniforms(self, u):
        """Inverse-transform sampling: tensor ``u [..., qmc_dim]`` in
        (0, 1) -> variates ``[...]`` on ``u``'s device. The structure of a
        low-discrepancy ``u`` survives the transform, hence inverse CDF and
        not rejection."""
        raise NotImplementedError(
            "%s has no uniform-transform sampler (needed for QMC)"
            % type(self).__name__)

    def _scipy(self):
        raise NotImplementedError

    def rvs(self, size=1, random_state=None):
        """Host draws (scipy-compatible; tests and host tooling)."""
        return self._scipy().rvs(size=size, random_state=random_state)

    def ppf(self, q):
        """Quantile function (host scipy)."""
        return self._scipy().ppf(q)

    def pdf(self, x):
        """Probability density (host scipy)."""
        return self._scipy().pdf(x)

    def cdf(self, x):
        """Cumulative distribution (host scipy)."""
        return self._scipy().cdf(x)

    def mean(self):
        """Exact mean."""
        return self._scipy().mean()

    def var(self):
        """Exact variance."""
        return self._scipy().var()


@dataclasses.dataclass(frozen=True)
class Norm(TorchDistr):
    loc: float = 0.0
    scale: float = 1.0

    def sample(self, generator, shape=(), device=None, dtype=torch.float64):
        z = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return self.loc + self.scale * z

    def from_standard_normals(self, z):
        return self.loc + self.scale * z

    def sample_uniforms(self, u):
        return self.loc + self.scale * torch.special.ndtri(u[..., 0])

    def _scipy(self):
        import scipy.stats as st

        return st.norm(loc=self.loc, scale=self.scale)


@dataclasses.dataclass(frozen=True)
class LogNorm(TorchDistr):
    """scipy.stats.lognorm(s, scale) parametrization:
    exp(log(scale) + s·N(0,1))."""

    s: float = 1.0
    scale: float = 1.0

    def sample(self, generator, shape=(), device=None, dtype=torch.float64):
        z = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return self.from_standard_normals(z)

    def from_standard_normals(self, z):
        return self.scale * torch.exp(self.s * z)

    def sample_uniforms(self, u):
        return self.from_standard_normals(torch.special.ndtri(u[..., 0]))

    def _scipy(self):
        import scipy.stats as st

        return st.lognorm(s=self.s, scale=self.scale)


@dataclasses.dataclass(frozen=True)
class Uniform(TorchDistr):
    lo: float = 0.0
    hi: float = 1.0

    def sample(self, generator, shape=(), device=None, dtype=torch.float64):
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return self.lo + (self.hi - self.lo) * u

    def sample_uniforms(self, u):
        return self.lo + (self.hi - self.lo) * u[..., 0]

    def _scipy(self):
        import scipy.stats as st

        return st.uniform(loc=self.lo, scale=self.hi - self.lo)


@dataclasses.dataclass(frozen=True)
class TwoGaussians(TorchDistr):
    """Mixture w·N(mu1, s1) + (1-w)·N(mu2, s2)."""

    w: float = 0.8
    mu1: float = 0.0
    s1: float = 1.0
    mu2: float = 5.0
    s2: float = 1.0

    qmc_dim = 2

    def sample(self, generator, shape=(), device=None, dtype=torch.float64):
        kwargs = dict(generator=generator, device=device, dtype=dtype)
        pick = torch.rand(shape, **kwargs) < self.w
        a = self.mu1 + self.s1 * torch.randn(shape, **kwargs)
        b = self.mu2 + self.s2 * torch.randn(shape, **kwargs)
        return torch.where(pick, a, b)

    def sample_uniforms(self, u):
        pick = u[..., 0] < self.w
        z = torch.special.ndtri(u[..., 1])
        return torch.where(pick, self.mu1 + self.s1 * z,
                           self.mu2 + self.s2 * z)

    def pdf(self, x):
        import scipy.stats as st

        return (self.w * st.norm(self.mu1, self.s1).pdf(x)
                + (1 - self.w) * st.norm(self.mu2, self.s2).pdf(x))

    def cdf(self, x):
        import scipy.stats as st

        return (self.w * st.norm(self.mu1, self.s1).cdf(x)
                + (1 - self.w) * st.norm(self.mu2, self.s2).cdf(x))

    def rvs(self, size=1, random_state=None):
        rng = np.random.default_rng(random_state)
        pick = rng.uniform(size=size) < self.w
        a = rng.normal(self.mu1, self.s1, size=size)
        b = rng.normal(self.mu2, self.s2, size=size)
        return np.where(pick, a, b)

    def mean(self):
        return self.w * self.mu1 + (1 - self.w) * self.mu2

    def var(self):
        m = self.mean()
        return (self.w * (self.s1 ** 2 + self.mu1 ** 2)
                + (1 - self.w) * (self.s2 ** 2 + self.mu2 ** 2) - m ** 2)

    def ppf(self, q):
        # numeric inversion over a generous bracket
        from scipy.optimize import brentq

        q = np.atleast_1d(q)
        lo = min(self.mu1 - 10 * self.s1, self.mu2 - 10 * self.s2)
        hi = max(self.mu1 + 10 * self.s1, self.mu2 + 10 * self.s2)
        return np.array([brentq(lambda x, qq=qq: self.cdf(x) - qq, lo, hi)
                         for qq in q])


_BY_NAME = {"norm": Norm, "lognorm": LogNorm, "uniform": Uniform,
            "two_gaussians": TwoGaussians}


def as_torch_distr(distr):
    """Coerce a name, a scipy frozen distribution (norm, lognorm, uniform)
    or a TorchDistr to a TorchDistr."""
    if isinstance(distr, TorchDistr):
        return distr
    if isinstance(distr, str):
        if distr.lower() in _BY_NAME:
            return _BY_NAME[distr.lower()]()
        raise ValueError("Unknown distribution name: {}".format(distr))
    dist_name = getattr(getattr(distr, "dist", None), "name", None)
    if dist_name == "norm":
        return Norm(float(distr.mean()), float(distr.std()))
    if dist_name == "lognorm":
        s = distr.kwds.get("s", distr.args[0] if distr.args else 1.0)
        return LogNorm(float(s), float(distr.kwds.get("scale", 1.0)))
    if dist_name == "uniform":
        loc = float(distr.kwds.get("loc", 0.0))
        return Uniform(loc, loc + float(distr.kwds.get("scale", 1.0)))
    raise ValueError(
        "Cannot map {} onto a torch sampler; pass a TorchDistr".format(distr))
