"""Correlated Gaussian random field generators (counterpart of
``mlmc_tpu/random/correlated_field.py``).

Field model: stationary covariance ``c(X) = sigma^2 exp(-|X^T K X|^(alpha/2))``
with ``K = (1/L^2) I`` (or an anisotropy tensor), alpha = 2 'gauss' / 1 'exp',
optional log-field. Three generators:

* ``SpatialCorrelatedField``: dense covariance + truncated SVD (KL
  expansion), sample = ``L @ N(0, 1)``. The decomposition runs on the host
  (``torch.linalg.svd``, or ``torch.svd_lowrank`` when fewer than half the
  terms are asked for); sampling is one matmul on the field's device.
* ``SpectralCorrelatedField``: random Fourier features,
  ``F(x) = sqrt(2/M) sum_m cos(k_m . x + phi_m)`` with ``k_m`` drawn from
  the spectral measure of the covariance (Gaussian for alpha = 2,
  multivariate Student-t(1) for alpha = 1). Works for arbitrary point sets.
  ``GSToolsSpatialCorrelatedField`` and ``FourierSpatialCorrelatedField``
  are API aliases of this class.
* ``CirculantEmbeddingField``: exact stationary GRF on a regular grid by
  d-dimensional FFT circulant embedding (``torch.fft.fftn`` at every size).

Every generator runs on the current CUDA device unless ``device`` names
another one. Randomness is explicit: ``sample(generator)`` draws from a
``torch.Generator`` (a generator of the field's own, seeded from ``seed``,
when none is passed), and every ``_sample`` has a twin that takes the
draws as an argument (``_sample_from(z)``, ``_sample_from(phases)``,
``_sample_from(wr, wi)``).
"""
import copy

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device


def kozeny_carman(porosity, m, factor, viscosity):
    """Kozeny-Carman porosity -> conductivity law (numpy or tensors)."""
    if not np.all(np.asarray(viscosity) > 1e-10):
        raise ValueError("viscosity must be positive")
    if isinstance(porosity, torch.Tensor):
        porosity = porosity.clamp(1e-10, 1 - 1e-10)
        cond = factor * porosity ** (2 + m) / (1 - porosity) ** 2 / viscosity
        return cond.clamp(min=1e-15)
    porosity = np.clip(porosity, 1e-10, 1 - 1e-10)
    cond = factor * porosity ** (2 + m) / (1 - porosity) ** 2 / viscosity
    return np.maximum(cond, 1e-15)


def positive_to_range(exp, a, b):
    """Map a positive parameter to the interval (a, b)."""
    return b * (1 - (b - a) / (b + (b - a) * exp))


def _host_generator(seed):
    """A CPU generator; ``seed=None`` takes a seed from the OS."""
    gen = torch.Generator()
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    return gen


def _draw(fn, shape, generator, device, dtype):
    """``fn(shape)`` (``torch.randn`` / ``torch.rand``) from ``generator``,
    on ``device``: a generator of another device draws there and the
    numbers are copied over."""
    x = fn(shape, generator=generator, device=generator.device, dtype=dtype)
    return x.to(device)


class RandomFieldBase:
    """Common stationary-covariance machinery."""

    #: named covariance families -> exponent alpha in exp(-r^alpha)
    _CORR_EXPONENTS = {"gauss": 2.0, "exp": 1.0}

    def __init__(self, corr_exp="gauss", dim=2, corr_length=1.0,
                 aniso_correlation=None, mu=0.0, sigma=1.0, log=False,
                 device=None, dtype=torch.float64, seed=None, **kwargs):
        """
        :param device: where samples are made; None = the current CUDA device
        :param dtype: floating dtype of the samples
        :param seed: seed of the field's own generator (``sample()`` without
            a generator) and of construction-time draws
        """
        self.dim = dim
        self.log = log
        self.device = resolve_device(device)
        self.dtype = dtype
        self.correlation_exponent = self._CORR_EXPONENTS.get(corr_exp) \
            or float(corr_exp)
        self._corr_length = corr_length

        if aniso_correlation is not None:
            self.correlation_tensor = np.asarray(aniso_correlation)
            self._max_corr_length = np.linalg.norm(aniso_correlation, ord=2)
        else:
            if corr_length <= np.finfo(float).eps:
                raise ValueError("corr_length must be positive")
            self.correlation_tensor = np.eye(dim) / corr_length ** 2
            self._max_corr_length = corr_length

        self.points = None
        self.mu, self.sigma = mu, sigma
        self._generator = _host_generator(seed)
        self._initialize(seed=seed, **kwargs)

    def _initialize(self, **kwargs):
        pass

    def _pointwise(self, value, n_points, name):
        """Broadcast-check a scalar or per-point array parameter."""
        arr = np.asarray(value, dtype=float)
        if arr.shape not in ((), (n_points,)):
            raise ValueError(
                "{} must be scalar or shape ({},), got {}".format(
                    name, n_points, arr.shape))
        return arr

    def set_points(self, points, mu=None, sigma=None):
        points = np.asarray(points, dtype=float)
        points = points.reshape(len(points), -1)  # 1-D input -> [N, 1]
        if points.shape[1] != self.dim:
            raise ValueError("points must be [N, {}]".format(self.dim))
        self.n_points, self.dimension = points.shape
        self.points = points
        self.mu = self._pointwise(self.mu if mu is None else mu,
                                  len(points), "mu")
        self.sigma = self._pointwise(self.sigma if sigma is None else sigma,
                                     len(points), "sigma")
        self._set_points()

    def _set_points(self):
        pass

    def _tensor(self, value):
        return torch.as_tensor(np.asarray(value), dtype=self.dtype,
                               device=self.device)

    def _finish(self, field):
        """sigma * field + mu, exponentiated for a log field."""
        field = self._tensor(self.sigma) * field + self._tensor(self.mu)
        return torch.exp(field) if self.log else field

    def sample(self, generator=None):
        """Field realization at the set points (a tensor on the field's
        device), drawn from ``generator`` (default: the field's own)."""
        if generator is None:
            generator = self._generator
        return self._finish(self._sample(generator))

    def _sample(self, generator):
        raise NotImplementedError

    # shared helper: anisotropic squared distance |X^T K X|
    def _sq_distance_matrix(self, points):
        d = points[:, None, :] - points[None, :, :]  # [N, N, dim]
        return np.einsum("ijk,kl,ijl->ij", d, self.correlation_tensor, d)


class SpatialCorrelatedField(RandomFieldBase):
    """Dense-covariance KL/SVD generator."""

    def _drop_factor(self):
        # any cached decomposition is invalid once points/params change
        self.cov_mat = self._cov_l_factor = None

    def _initialize(self, **kwargs):
        self._drop_factor()
        self._n_approx_terms = self._sqrt_ev = None

    def _set_points(self):
        self._drop_factor()

    def cov_matrix(self):
        """Dense covariance matrix at the set points (host numpy)."""
        if self.points is None:
            raise ValueError("set_points first")
        sq = self._sq_distance_matrix(self.points)
        # c(X) = exp(-(X^T K X)^(alpha/2)) with sq = X^T K X
        self.cov_mat = np.exp(-np.abs(sq) ** (self.correlation_exponent / 2.0))
        return self.cov_mat

    def _eigen_value_estimate(self, m):
        """Schwab-Todor decay estimate of the m-th eigenvalue."""
        vol = np.prod(np.max(self.points, axis=0) - np.min(self.points, axis=0)) \
            + np.finfo(float).eps
        lam = self._max_corr_length
        alpha = lam / (2 * vol ** (1 / self.dim))
        return vol * (1.0 / alpha) ** (m ** (1 / self.dim)) if alpha > 1 else \
            vol * np.exp(-alpha * m ** (1 / self.dim) * np.log(m + 1))

    def svd_dcmp(self, precision=0.01, n_terms_range=(1, np.inf), random_state=None):
        """Truncated SVD of the covariance -> KL factor.

        Keeps the smallest number of terms with relative singular-value
        tail below ``precision`` within ``n_terms_range``. Fewer than half
        the terms: a randomized range finder (``torch.svd_lowrank``, seeded
        by ``random_state``); else the full SVD.
        """
        if self.cov_mat is None:
            self.cov_matrix()
        n = self.cov_mat.shape[0]
        hi = int(min(n_terms_range[1], n))
        lo = int(max(1, n_terms_range[0]))

        cov = torch.from_numpy(np.ascontiguousarray(self.cov_mat))
        if hi < n // 2:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0 if random_state is None else int(random_state))
                U, s, _ = torch.svd_lowrank(cov, q=min(hi + 10, n), niter=3)
            U, s = U[:, :hi].numpy(), s[:hi].numpy()
        else:
            U, s, _ = torch.linalg.svd(cov)
            U, s = U[:, :hi].numpy(), s[:hi].numpy()

        total = np.sum(s)
        tail = total - np.cumsum(s)
        keep = int(np.searchsorted(-tail, -precision * total)) + 1
        keep = int(np.clip(keep, lo, hi))

        self._sqrt_ev = np.sqrt(s[:keep])
        self._cov_l_factor = U[:, :keep] * self._sqrt_ev[None, :]
        self._n_approx_terms = keep
        return self._cov_l_factor, self._sqrt_ev

    @property
    def n_approx_terms(self):
        return self._n_approx_terms

    def _sample_from(self, z):
        """``L @ z`` for given standard normals ``z`` [n_approx_terms]."""
        return self._tensor(self._cov_l_factor) @ z.to(self.device, self.dtype)

    def _sample(self, generator):
        if self._cov_l_factor is None:
            self.svd_dcmp()
        return self._sample_from(_draw(torch.randn, (self._n_approx_terms,),
                                       generator, self.device, self.dtype))


class SpectralCorrelatedField(RandomFieldBase):
    """Random-Fourier-feature generator.

    F(x) = sqrt(2/M) sum_m cos(k_m . x + phi_m); k_m drawn from the spectral
    measure of the covariance: N(0, 2/L^2 I) for alpha = 2 (gauss),
    multivariate Student-t(nu=1)/L for alpha = 1 (exp).
    """

    def _initialize(self, mode_no=1000, seed=None, **kwargs):
        self.mode_no = int(mode_no)
        gen = self._generator  # the wave vectors come first in its stream
        d = self.dim
        alpha = self.correlation_exponent
        L = self._corr_length
        y = torch.randn((self.mode_no, d), generator=gen, dtype=torch.float64)
        if alpha == 2.0:
            # FT of exp(-r^2/L^2): k ~ N(0, 2/L^2 I)
            k = y * (np.sqrt(2.0) / L)
        elif alpha == 1.0:
            # FT of exp(-r/L): multivariate Student-t with nu=1, scale 1/L
            w = torch.randn((self.mode_no, 1), generator=gen,
                            dtype=torch.float64) ** 2      # chi-square(1)
            k = y / torch.sqrt(w) / L
        else:
            raise NotImplementedError(
                "spectral sampling implemented for alpha in {1, 2}, got {}".format(alpha))
        self._wave_vectors = k.to(self.device, self.dtype)   # [M, d]

    def _sample_from(self, phases):
        """The field for given mode phases [M]."""
        proj = self._tensor(self.points) @ self._wave_vectors.T   # [N, M]
        phases = phases.to(self.device, self.dtype)
        return np.sqrt(2.0 / self.mode_no) * torch.sum(
            torch.cos(proj + phases[None, :]), dim=1)

    def _sample(self, generator):
        return self._sample_from(2 * np.pi * _draw(
            torch.rand, (self.mode_no,), generator, self.device, self.dtype))


class GSToolsSpatialCorrelatedField(SpectralCorrelatedField):
    """API-parity subclass of the spectral generator. Accepts a
    gstools-like model object with ``len_scale``/``dim`` attributes or
    plain kwargs."""

    def __init__(self, model=None, **kwargs):
        if model is not None:
            kwargs.setdefault("corr_length", getattr(model, "len_scale", 1.0))
            kwargs.setdefault("dim", getattr(model, "dim", 2))
            name = type(model).__name__.lower()
            kwargs.setdefault("corr_exp",
                              "exp" if "exponential" in name else "gauss")
        super().__init__(**kwargs)


class FourierSpatialCorrelatedField(SpectralCorrelatedField):
    """API-parity subclass: the spectral method under its older name."""


class CirculantEmbeddingField(RandomFieldBase):
    """Exact stationary GRF on a regular grid via FFT circulant embedding.

    Eigenvalues of the embedded circulant = FFT of one covariance row; a
    sample is ``real(FFT(sqrt(eig) * W)) / sqrt(M)`` with complex white
    noise W. O(N log N), exact covariance.

    :param grid_shape: points per dimension, e.g. (256, 256)
    :param grid_step: spacing per dimension (scalar or per-dim)
    """

    def _initialize(self, grid_shape=None, grid_step=1.0, pad_factor=2, **kwargs):
        if grid_shape is None:
            raise ValueError("CirculantEmbeddingField needs grid_shape")
        self.grid_shape = tuple(int(s) for s in grid_shape)
        step = np.broadcast_to(np.asarray(grid_step, dtype=float), (self.dim,))
        self.grid_step = step
        self._pad_factor = pad_factor
        self._build_eigenvalues()
        # implicit point set = the grid itself
        axes = [np.arange(s) * st for s, st in zip(self.grid_shape, step)]
        mesh = np.meshgrid(*axes, indexing="ij")
        self.points = np.stack([m.ravel() for m in mesh], axis=1)
        self.n_points = self.points.shape[0]
        self.mu = np.array(self.mu, dtype=float)
        self.sigma = np.array(self.sigma, dtype=float)

    def _build_eigenvalues(self):
        """FFT of the covariance kernel on the embedding torus (host f64;
        ``_eig_np`` keeps the numpy array, ``_eig`` the device tensor)."""
        emb_shape = tuple(self._pad_factor * s for s in self.grid_shape)
        # signed torus distances per axis
        axes = []
        for s, st in zip(emb_shape, self.grid_step):
            ix = np.arange(s)
            ix = np.minimum(ix, s - ix)  # wrap-around distance
            axes.append(ix * st)
        mesh = np.meshgrid(*axes, indexing="ij")
        d = np.stack([m.ravel() for m in mesh], axis=1)  # [prod(emb), dim]
        sq = np.einsum("ik,kl,il->i", d, self.correlation_tensor, d)
        cov = np.exp(-np.abs(sq) ** (self.correlation_exponent / 2.0))
        cov = cov.reshape(emb_shape)
        eig = np.fft.fftn(cov).real
        # tiny negative eigenvalues from imperfect embedding -> clip
        self._neg_fraction = float(np.abs(eig[eig < 0]).sum() / np.abs(eig).sum()) \
            if np.any(eig < 0) else 0.0
        self._eig_np = np.maximum(eig, 0.0)
        self._eig = self._tensor(self._eig_np)
        self._emb_shape = emb_shape
        self._emb_size = int(np.prod(emb_shape))

    def set_points(self, points=None, mu=None, sigma=None):
        """Points are fixed to the grid; only mu/sigma may be updated."""
        if points is not None:
            raise ValueError(
                "CirculantEmbeddingField samples on its regular grid; "
                "use SpatialCorrelatedField / SpectralCorrelatedField for "
                "arbitrary point sets")
        if mu is not None:
            self.mu = np.array(mu, dtype=float)
        if sigma is not None:
            self.sigma = np.array(sigma, dtype=float)

    def _sample_from(self, wr, wi):
        """The field for given white noise (real and imaginary part, each
        of the embedding's shape):
        X = Re(F sqrt(Lambda) xi) / sqrt(M), xi complex with unit-variance
        real and imaginary parts  =>  Cov(X) = C exactly."""
        w = torch.complex(wr.to(self.device, self.dtype),
                          wi.to(self.device, self.dtype))
        field = torch.fft.fftn(torch.sqrt(self._eig) * w).real \
            / np.sqrt(self._emb_size)
        # crop embedding torus back to the grid
        slices = tuple(slice(0, s) for s in self.grid_shape)
        return field[slices].reshape(-1)

    def _sample(self, generator):
        wr = _draw(torch.randn, self._emb_shape, generator, self.device, self.dtype)
        wi = _draw(torch.randn, self._emb_shape, generator, self.device, self.dtype)
        return self._sample_from(wr, wi)

    def sample_grid(self, generator=None):
        """Sample shaped as the grid (not flattened)."""
        return self.sample(generator).reshape(self.grid_shape)


class Field:
    """Named field over an (optional) mesh-region subset.

    Three flavors, classified once at construction into a ``kind`` tag:

    * ``const``   — ``Field("porosity", 0.3)``
    * ``random``  — ``Field("logK", SpatialCorrelatedField(...))``
    * ``derived`` — ``Field("K", kozeny_carman_fn, ["porosity", "visc"])``
      (a pure function of other fields' realizations, resolved by Fields)

    Realizations are host numpy arrays.
    """

    def __init__(self, name, field=None, param_fields=[], regions=[]):
        self.name = name
        self.regions = [regions] if isinstance(regions, str) else list(regions)
        self.param_fields = list(param_fields)
        self.is_outer = True
        self._realization = None
        self.full_sample_ids = None

        if isinstance(field, (int, float)) and not isinstance(field, bool):
            self.kind = "const"
            self.generator = float(field)
        elif isinstance(field, RandomFieldBase):
            self.kind = "random"
            self.generator = field
        elif callable(field):
            self.kind = "derived"
            self.generator = field
            if not self.param_fields:
                raise ValueError(
                    "derived field {!r} needs param_fields to feed the "
                    "function".format(name))
            try:  # fail fast on arity/shape mismatches
                field(*(np.ones(2),) * len(self.param_fields))
            except Exception as exc:
                raise ValueError(
                    "derived field {!r}: function rejected probe "
                    "arguments".format(name)) from exc
        else:
            raise ValueError(
                "field {!r} must be a number, a RandomFieldBase, or a "
                "callable; got {!r}".format(name, field))
        if self.kind != "derived" and self.param_fields:
            raise ValueError(
                "param_fields only apply to derived (callable) fields")

    def set_points(self, points):
        if self.kind == "const":
            self._realization = np.full(len(points), self.generator)
        elif self.kind == "random":
            self.generator.set_points(points)
            if type(self.generator) is SpatialCorrelatedField:
                self.generator.svd_dcmp(n_terms_range=(10, 100))

    def sample(self, generator=None):
        if self.kind == "random":
            self._realization = self.generator.sample(generator).cpu().numpy()
        elif self.kind == "derived":
            self._realization = self.generator(
                *(pf._realization for pf in self.param_fields))
        return self._realization


class Fields:
    """Set of cross-dependent named fields over mesh regions: region
    restriction, derived-field dependency resolution by name, and
    outer-field selection of which realizations the simulation receives.

    :param seed: seed of the set's own generator (``sample()`` without one)
    """

    def __init__(self, fields, seed=None):
        # fields register in declaration order and parameters resolve only
        # against ALREADY-DECLARED names: sample() evaluates in list order,
        # so a forward reference would read a stale (or missing)
        # realization — reject it at construction instead
        self.fields = []
        self.by_name = {}
        for f in fields:
            field = copy.copy(f)
            field.param_fields = [self._resolve(p, field.regions)
                                  for p in field.param_fields]
            self.fields.append(field)
            self.by_name[field.name] = field
        self._generator = _host_generator(seed)

    def _resolve(self, param, regions):
        """A derived field's parameter: an already-declared field name, or
        a bare number (auto-wrapped as an anonymous constant field)."""
        if isinstance(param, (int, float)) and not isinstance(param, bool):
            const = Field("const_{}".format(param), param, regions=regions)
            self.fields.insert(0, const)
            self.by_name[const.name] = const
            return const
        if param not in self.by_name:
            raise KeyError(
                "field {!r} referenced before its definition (evaluation "
                "follows declaration order); declared so far: {}".format(
                    param, sorted(self.by_name)))
        return self.by_name[param]

    @property
    def names(self):
        return self.by_name.keys()

    def set_outer_fields(self, outer):
        outer = set(outer)
        for f in self.fields:
            f.is_outer = f.name in outer

    def set_points(self, points, region_ids=[], region_map={}):
        """Attach mesh points; region-restricted fields only see the points
        whose region id maps into their region list.

        Omitting BOTH region arguments treats every point as belonging to
        every declared region; passing region ids without the name->id map
        (or vice versa) is an error — defaulting one of them would silently
        select zero points for region-restricted fields.
        """
        self.n_elements = len(points)
        restricted = any(f.regions for f in self.fields)
        if len(region_ids) == 0 and not region_map:
            region_ids = np.zeros(self.n_elements, dtype=int)
            region_map = {r: 0 for f in self.fields for r in f.regions}
        elif len(region_ids) == 0 or (not region_map and restricted):
            raise ValueError(
                "region_ids and region_map must be passed together "
                "(got {} ids, map {})".format(len(region_ids), region_map))
        region_ids = np.asarray(region_ids)
        if len(region_ids) != self.n_elements:
            raise ValueError("one region id per point required")

        for field in self.fields:
            if field.regions:
                wanted = np.asarray([region_map[r] for r in field.regions])
                ids = np.flatnonzero(np.isin(region_ids, wanted))
            else:
                ids = np.arange(self.n_elements)
            field.full_sample_ids = ids
            field.set_points(points[ids])

    def sample(self, generator=None):
        """One realization of every outer field, scattered back onto the
        full element set (zeros outside a field's regions). The fields
        draw from ``generator`` in declaration order.

        :return: {field_name: [n_elements] array}
        """
        if generator is None:
            generator = self._generator
        result = {}
        for field in self.fields:
            values = field.sample(generator)
            if field.is_outer:
                full = np.zeros(self.n_elements)
                full[field.full_sample_ids] = np.asarray(values)
                result[field.name] = full
        return result
