"""Generalized moment-function bases on PyTorch tensors.

Counterpart of ``mlmc_tpu/moments.py``. Every basis evaluates a whole batch
at once: ``eval_all`` maps a tensor of values (any device, any float dtype)
to its Vandermonde ``[..., size]``, and the numpy twins ``transform_np`` /
``eval_all_np`` serve host consumers such as the maxent quadrature.
``safe_eval`` clipping turns out-of-domain values into NaN lanes, which the
estimators mask.

Parity (checked by tests/test_torch_moments.py against ``mlmc_tpu``):
  Monomial   == numpy.polynomial.polynomial.polyvander on the transformed value
  Legendre   == numpy.polynomial.legendre.legvander (same three-term recurrence)
  Fourier    == [1, cos(kx), sin(kx) interleaved]
"""
import inspect

import numpy as np
import torch


def _as_tensor(value):
    """Float tensor of at least one dimension; numpy float arrays keep
    their dtype, anything else becomes float64."""
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value)
        if not np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float64)
        value = torch.from_numpy(np.ascontiguousarray(arr))
    if not value.is_floating_point():
        value = value.to(torch.float64)
    if value.ndim == 0:
        value = value[None]
    return value


class Moments:
    """Base class: domain transform + optional log + safe clipping to NaN.

    Contract of ``mlmc_tpu.moments.Moments``: ``size``, ``domain``,
    ``transform``/``inv_transform``, ``eval_all``, ``eval``, the
    derivative evaluations ``eval_all_der``/``eval_diff``/``eval_diff2``,
    ``change_size`` and ``__eq__``.
    """

    ref_domain = (0.0, 1.0)

    def __init__(self, size, domain, log=False, safe_eval=True):
        assert size > 0
        self.size = int(size)
        self.domain = (float(domain[0]), float(domain[1]))
        self._is_log = bool(log)
        self._is_clip = bool(safe_eval)

        if log:
            lin_domain = (np.log(self.domain[0]), np.log(self.domain[1]))
        else:
            lin_domain = self.domain

        diff = lin_domain[1] - lin_domain[0]
        assert diff > 0
        diff = max(diff, 1e-15)
        self._linear_scale = (self.ref_domain[1] - self.ref_domain[0]) / diff
        self._linear_shift = lin_domain[0]

    # ------------------------------------------------------------------ #
    # value transforms (tensors)
    # ------------------------------------------------------------------ #
    def linear(self, value):
        """Affine map from the user domain onto the reference domain."""
        return (value - self._linear_shift) * self._linear_scale + self.ref_domain[0]

    def inv_linear(self, value):
        """Inverse of :meth:`linear` (reference -> user domain)."""
        return (value - self.ref_domain[0]) / self._linear_scale + self._linear_shift

    def clip(self, value):
        """Replace values outside the reference domain with NaN."""
        lo, hi = self.ref_domain
        bad = (value < lo) | (value > hi)
        return torch.where(bad, torch.full_like(value, float("nan")), value)

    def transform(self, value):
        """Full forward transform: optional log, affine map, optional
        out-of-domain clipping to NaN (``safe_eval``)."""
        value = _as_tensor(value)
        if self._is_log:
            value = torch.log(value)
        value = self.linear(value)
        if self._is_clip:
            value = self.clip(value)
        return value

    def inv_transform(self, ref):
        """Map reference-domain values back to the user domain."""
        out = self.inv_linear(_as_tensor(ref))
        if self._is_log:
            out = torch.exp(out)
        return out

    # ------------------------------------------------------------------ #
    # protocol
    # ------------------------------------------------------------------ #
    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.size == other.size
            and np.all(np.array(self.domain) == np.array(other.domain))
            and self._is_log == other._is_log
            and self._is_clip == other._is_clip
        )

    def __hash__(self):
        return hash((type(self).__name__, self.size, self.domain, self._is_log, self._is_clip))

    def change_size(self, size):
        """Same basis/domain/flags (and reference domain) with another
        moment count."""
        kwargs = dict(log=self._is_log, safe_eval=self._is_clip)
        if "ref_domain" in inspect.signature(self.__class__.__init__).parameters:
            kwargs["ref_domain"] = self.ref_domain
        return self.__class__(size, self.domain, **kwargs)

    def __call__(self, value):
        return self._eval_all(value, self.size)

    def eval(self, i, value):
        """Value of the i-th moment function."""
        return self._eval_all(value, i + 1)[..., -1]

    def eval_single_moment(self, i, value):
        """i-th moment values, broadcasting over ``value``'s shape."""
        return self._eval_all(value, i + 1)[..., i]

    def eval_all(self, value, size=None):
        """Vandermonde of the first ``size`` moment functions:
        ``[*value.shape, size]`` on the value's device and dtype."""
        return self._eval_all(value, self.size if size is None else size)

    def eval_all_der(self, value, size=None, degree=1):
        """``degree``-th derivatives of the moment functions with respect
        to the reference variable (bases that define them: Legendre)."""
        return self._eval_all_der(
            value, self.size if size is None else size, degree)

    def eval_diff(self, value, size=None):
        """First derivatives through the basis' differentiation matrix."""
        return self._eval_diff(value, self.size if size is None else size)

    def eval_diff2(self, value, size=None):
        """Second derivatives through the squared differentiation matrix."""
        return self._eval_diff2(value, self.size if size is None else size)

    def _eval_all(self, value, size):
        return self._eval_ref(self.transform(value), size)

    def _eval_ref(self, t, size):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # numpy twins for host consumers (maxent quadrature)
    # ------------------------------------------------------------------ #
    def transform_np(self, value):
        """Host-numpy twin of :meth:`transform` (same semantics)."""
        value = np.asarray(value, dtype=float)
        if self._is_log:
            value = np.log(value)
        value = (value - self._linear_shift) * self._linear_scale + self.ref_domain[0]
        if self._is_clip:
            lo, hi = self.ref_domain
            value = np.where((value < lo) | (value > hi), np.nan, value)
        return value

    def eval_all_np(self, value, size=None):
        """Host-numpy twin of :meth:`eval_all`."""
        if size is None:
            size = self.size
        t = self.transform_np(np.atleast_1d(value))
        return self._eval_ref_np(t, size)

    def _eval_ref_np(self, t, size):
        raise NotImplementedError


def legvander(x, deg):
    """Legendre Vandermonde [..., deg+1] via the three-term recurrence
    P_n = ((2n-1)·x·P_{n-1} - (n-1)·P_{n-2}) / n (numpy's legvander)."""
    # x*0 + 1 (not ones_like) so NaN lanes poison the constant column
    cols = [x * 0 + 1]
    if deg > 0:
        cols.append(x)
    for n in range(2, deg + 1):
        cols.append((cols[-1] * x * (2 * n - 1) - cols[-2] * (n - 1)) / n)
    return torch.stack(cols, dim=-1)


def polyvander(x, deg):
    """Monomial Vandermonde [..., deg+1]: 1, x, x², ... (NaN-propagating)."""
    cols = [x * 0 + 1]
    for _ in range(deg):
        cols.append(cols[-1] * x)
    return torch.stack(cols, dim=-1)


def legendre_diff_mat(size):
    """d/dx in the Legendre-Vandermonde representation:
    ``vander @ diff_mat`` evaluates the derivatives of P_0..P_{size-1}
    (diff_mat[n, n+1::2] = 2n+1)."""
    mat = np.zeros((size, size))
    for n in range(size - 1):
        mat[n, n + 1::2] = 2 * n + 1
    return mat


def _times_matrix(vander, mat):
    """``vander @ mat`` with the numpy matrix on the Vandermonde's device
    and dtype."""
    return vander @ torch.as_tensor(np.ascontiguousarray(mat),
                                    dtype=vander.dtype, device=vander.device)


class Monomial(Moments):
    """Monomial moments on the reference domain (0, 1)."""

    def __init__(self, size, domain=(0, 1), ref_domain=None, log=False, safe_eval=True):
        self.ref_domain = tuple(ref_domain) if ref_domain is not None else (0.0, 1.0)
        super().__init__(size, domain, log=log, safe_eval=safe_eval)

    def _eval_ref(self, t, size):
        return polyvander(t, size - 1)

    def _eval_ref_np(self, t, size):
        return np.polynomial.polynomial.polyvander(t, size - 1)

    def eval(self, i, value):
        """i-th monomial ``t**i`` on the transformed value."""
        return self.transform(value) ** i


class Fourier(Moments):
    """Fourier moments [1, cos kx, sin kx] on the reference domain (0, 2π)."""

    def __init__(self, size, domain=(0, 2 * np.pi), ref_domain=None, log=False, safe_eval=True):
        self.ref_domain = tuple(ref_domain) if ref_domain is not None else (0.0, 2 * np.pi)
        super().__init__(size, domain, log=log, safe_eval=safe_eval)

    def _eval_ref(self, t, size):
        R = size // 2
        shorter_sin = 1 - size % 2
        k = torch.arange(1, R + 1, dtype=t.dtype, device=t.device)
        kx = t[..., None] * k
        out = torch.empty(t.shape + (size,), dtype=t.dtype, device=t.device)
        # t*0 + 1 keeps clipped (NaN) inputs poisoned even when size == 1
        out[..., 0] = t * 0.0 + 1.0
        out[..., 1::2] = torch.cos(kx)
        out[..., 2::2] = torch.sin(kx[..., : R - shorter_sin])
        return out

    def _eval_ref_np(self, t, size):
        R = size // 2
        shorter_sin = 1 - size % 2
        k = np.arange(1, R + 1, dtype=float)
        kx = t[..., None] * k
        out = np.empty(t.shape + (size,), dtype=float)
        out[..., 0] = t * 0.0 + 1.0
        out[..., 1::2] = np.cos(kx)
        out[..., 2::2] = np.sin(kx[..., : R - shorter_sin])
        return out

    def eval(self, i, value):
        """Single Fourier mode as the original library indexes it: 1 for
        i == 0, sin((i-1)/2·t) at odd i, cos(i/2·t) at even i."""
        t = self.transform(value)
        if i == 0:
            return torch.ones_like(t)
        if i % 2 == 1:
            return torch.sin((i - 1) / 2 * t)
        return torch.cos(i / 2 * t)


class Legendre(Moments):
    """Legendre moments on the reference domain (-1, 1)."""

    def __init__(self, size, domain, ref_domain=None, log=False, safe_eval=True):
        self.ref_domain = tuple(ref_domain) if ref_domain is not None else (-1.0, 1.0)
        self.diff_mat = legendre_diff_mat(size)
        self.diff2_mat = self.diff_mat @ self.diff_mat
        super().__init__(size, domain, log, safe_eval)

    def _eval_ref(self, t, size):
        return legvander(t, size - 1)

    def _eval_ref_np(self, t, size):
        return np.polynomial.legendre.legvander(t, size - 1)

    def _eval_all_der(self, value, size, degree=1):
        dmat = np.linalg.matrix_power(legendre_diff_mat(size), degree)
        return _times_matrix(self._eval_all(value, size), dmat)

    def _eval_diff(self, value, size):
        return _times_matrix(self._eval_all(value, size),
                             self.diff_mat[:size, :size])

    def _eval_diff2(self, value, size):
        return _times_matrix(self._eval_all(value, size),
                             self.diff2_mat[:size, :size])


class TransformedMoments(Moments):
    """new_moments = matrix · old_moments."""

    def __init__(self, other_moments, matrix):
        n, m = np.asarray(matrix).shape
        assert m == other_moments.size
        self.size = int(n)
        self.domain = other_moments.domain
        self._origin = other_moments
        self._transform_mat = np.asarray(matrix)

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.size == other.size
            and self._origin == other._origin
            and np.all(self._transform_mat == other._transform_mat)
        )

    def __hash__(self):
        return hash((type(self).__name__, self.size, hash(self._origin)))

    def _apply(self, orig, size):
        return _times_matrix(orig, self._transform_mat.T)[..., :size]

    def _eval_ref(self, t, size):
        return self._apply(self._origin._eval_ref(t, self._origin.size), size)

    def _eval_all(self, value, size):
        return self._apply(
            self._origin._eval_all(value, self._origin.size), size)

    def _eval_all_der(self, value, size, degree=1):
        return self._apply(self._origin._eval_all_der(
            value, self._origin.size, degree=degree), size)

    def _eval_diff(self, value, size):
        return self._apply(
            self._origin.eval_diff(value, self._origin.size), size)

    def _eval_diff2(self, value, size):
        return self._apply(
            self._origin.eval_diff2(value, self._origin.size), size)

    def eval_all_np(self, value, size=None):
        """Host-numpy path: origin Vandermonde times the transform."""
        if size is None:
            size = self.size
        orig = self._origin.eval_all_np(value, self._origin.size)
        return (orig @ self._transform_mat.T)[..., :size]

    def transform(self, value):
        """Delegates to the origin basis (same domain handling)."""
        return self._origin.transform(value)

    def inv_transform(self, ref):
        """Delegates to the origin basis."""
        return self._origin.inv_transform(ref)
