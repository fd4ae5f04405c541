"""Fracture networks rasterized into the Darcy conductivity (counterpart of
``mlmc_tpu/random/frac_geom.py``).

* ``sample_fracture_network`` (2-D segments) and
  ``sample_fracture_network_3d`` (penny-shaped discs): a network is a
  function of explicit draws (``FractureDraws``: uniform centers, uniform
  size quantiles of a truncated Pareto law, and orientations: uniform
  angles, or normals around a preferred direction), so that it replays
  from its draws on any device. The draws come from a generator
  (``fracture_draws``) or from a sample's keyed Philox stream
  (``keyed_fracture_draws``, on calls of its own);
* ``fracture_min_distance`` / ``fracture_indicator`` /
  ``fracture_indicator_3d``: cells whose centers lie within
  ``max(aperture, h) / 2`` of a fracture, computed in the order of
  ``mlmc_tpu`` so that cells at the threshold decide alike;
* ``fracture_conductivity(_3d)``: the bulk conductivity times the contrast
  inside fractures;
* ``FracturedDiffusionSimulation(3D)``: Darcy flow whose bulk GRF and
  network are drawn once per sample; the fine grid and the coarse grid of
  a sample see the same network (rasterized at both sizes, or, on the
  circulant route, the coarse K point-samples the fine fractured K).

Every function takes leading batch dimensions (one network per sample).
``make_frac_mesh`` (the reference's geomop + gmsh mesh builder) stays
descoped and raises ``ImportError``.
"""
from typing import NamedTuple

import numpy as np
import torch

from mlmc_tpu_torch.random.keyed import keyed_normals, keyed_uniforms
from mlmc_tpu_torch.sim.diffusion import DiffusionSimulation
from mlmc_tpu_torch.sim.diffusion3d import DiffusionSimulation3D
from mlmc_tpu_torch.sim.simulation import config_dtype

#: first Philox call of a sample's fracture draws in its keyed stream: the
#: field's draws take the calls below it
FRACTURE_CALL = 1 << 19
#: first call of the normally distributed fracture draws
FRACTURE_NORMALS_CALL = FRACTURE_CALL + (1 << 18)
#: elements of the largest [b, P, F, dim] temporary of an indicator; larger
#: batches are rasterized in chunks of samples
INDICATOR_CHUNK_ELEMENTS = 1 << 26


class FractureDraws(NamedTuple):
    """The draws of fracture networks, each with leading batch dimensions:
    centers [..., F, dim] uniform in [0, 1), sizes [..., F] uniform in
    [0, 1), orientations: 2-D [..., F] uniform in [0, 1) (isotropic) or
    standard normal (concentrated angles), 3-D [..., F, 3] standard normal."""

    centers: torch.Tensor
    sizes: torch.Tensor
    orientations: torch.Tensor


def _orientation_shape(n_fractures, dim):
    return (n_fractures,) if dim == 2 else (n_fractures, 3)


def fracture_draws(generator, n_fractures, dim=2, normal_orientations=False,
                   batch=(), device=None, dtype=torch.float32):
    """The draws of ``batch`` networks from ``generator`` (centers, then
    sizes, then orientations), on ``device`` (None: the generator's).

    :param normal_orientations: 2-D: draw normals for the angles (a
        concentrated family); 3-D orientations are always normal
    """
    batch = (int(batch),) if np.ndim(batch) == 0 else tuple(batch)
    device = generator.device if device is None else device

    def draw(fn, shape):
        return fn(batch + shape, generator=generator, device=generator.device,
                  dtype=dtype).to(device)

    centers = draw(torch.rand, (n_fractures, dim))
    sizes = draw(torch.rand, (n_fractures,))
    normal = normal_orientations or dim == 3
    orientations = draw(torch.randn if normal else torch.rand,
                        _orientation_shape(n_fractures, dim))
    return FractureDraws(centers, sizes, orientations)


def keyed_fracture_draws(seed, level_id, indices, attempts, n_fractures, dim=2,
                         normal_orientations=False, dtype=torch.float32):
    """The draws of one network per sample (seed, level, index, attempt),
    from the calls of its keyed stream at ``FRACTURE_CALL`` and
    ``FRACTURE_NORMALS_CALL`` (disjoint from the field's draws)."""
    F = int(n_fractures)
    normal = normal_orientations or dim == 3
    n_uniform = F * dim + F + (0 if normal else F)
    u = keyed_uniforms(seed, level_id, indices, attempts, n_uniform, dtype,
                       first_call=FRACTURE_CALL)
    B = indices.shape[0]
    centers = u[:, :F * dim].reshape(B, F, dim)
    sizes = u[:, F * dim:F * dim + F]
    if normal:
        shape = _orientation_shape(F, dim)
        orientations = keyed_normals(
            seed, level_id, indices, attempts, int(np.prod(shape)), dtype,
            first_call=FRACTURE_NORMALS_CALL).reshape((B,) + shape)
    else:
        orientations = u[:, F * dim + F:]
    return FractureDraws(centers, sizes, orientations)


def _truncated_pareto(u, size_range, power):
    """Inverse CDF of the Pareto law with exponent ``power`` truncated to
    ``size_range``."""
    lo, hi = size_range
    a = power - 1.0
    cdf_hi = 1.0 - (lo / hi) ** a
    return lo * (1.0 - u * cdf_hi) ** (-1.0 / a)


def _in_box(u, box):
    lo = torch.tensor(box[0], dtype=u.dtype, device=u.device)
    hi = torch.tensor(box[1], dtype=u.dtype, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


# ===================================================================== #
# 2-D fracture networks: line segments
# ===================================================================== #
def sample_fracture_network(draws, n_fractures, box=((0.0, 0.0), (1.0, 1.0)),
                            size_range=(0.1, 0.6), power=1.8,
                            mean_angle=0.0, concentration=0.0):
    """Random fracture set as line segments.

    :param draws: ``FractureDraws`` (angles normal iff concentration > 0),
        or a ``torch.Generator`` to draw one network from
    :param n_fractures: the count F
    :param box: ((x0, y0), (x1, y1)) domain
    :param size_range: (min, max) fracture lengths (truncated Pareto)
    :param power: Pareto exponent of the length distribution (> 1)
    :param mean_angle: preferred orientation (radians)
    :param concentration: 0 = isotropic (uniform angles); larger values
        concentrate the angles around ``mean_angle`` (normal with std
        1/sqrt(concentration))
    :return: segments [..., F, 2, 2] (endpoint pairs)
    """
    if isinstance(draws, torch.Generator):
        draws = fracture_draws(draws, n_fractures, 2, concentration > 0,
                               dtype=torch.float64)
    if draws.centers.shape[-2] != n_fractures:
        raise ValueError("the draws hold %d fractures, not %d"
                         % (draws.centers.shape[-2], n_fractures))
    centers = _in_box(draws.centers, box)
    lengths = _truncated_pareto(draws.sizes, size_range, power)
    if concentration > 0:
        angles = mean_angle + draws.orientations / np.sqrt(concentration)
    else:
        angles = draws.orientations * np.pi
    half = 0.5 * lengths[..., None] * torch.stack(
        [torch.cos(angles), torch.sin(angles)], dim=-1)
    return torch.stack([centers - half, centers + half], dim=-2)


def fracture_min_distance(segments, points):
    """Min distance of each point to any segment.

    :param segments: [..., F, 2, 2]
    :param points: [P, 2]
    :return: [..., P] distances
    """
    p0 = segments[..., 0, :]                       # [..., F, 2]
    d = segments[..., 1, :] - p0
    len2 = torch.clamp(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1], min=1e-30)
    rel = points[:, None, :] - p0[..., None, :, :]  # [..., P, F, 2]
    dot = rel[..., 0] * d[..., None, :, 0] + rel[..., 1] * d[..., None, :, 1]
    t = torch.clamp(dot / len2[..., None, :], 0.0, 1.0)
    closest = p0[..., None, :, :] + t[..., None] * d[..., None, :, :]
    diff = points[:, None, :] - closest
    dist = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    return dist.min(dim=-1).values


def _cell_centers(box, n, dtype, device):
    """Per-axis cell centers of an n-cell grid over ``box``, as mlmc_tpu
    computes them; and the x step h."""
    lo, hi = box
    h = (hi[0] - lo[0]) / n
    ar = torch.arange(n, dtype=dtype, device=device) + 0.5
    axes = [lo[0] + ar * h] + [lo[k] + ar * ((hi[k] - lo[k]) / n)
                               for k in range(1, len(lo))]
    return axes, h


def _by_sample_chunks(fn, tensors, batch_shape, elements_per_sample):
    """``fn`` over chunks of samples of ``tensors`` (each with the leading
    dimensions ``batch_shape``), at most ``INDICATOR_CHUNK_ELEMENTS``
    temporary elements per chunk; the results concatenated and given the
    leading dimensions back."""
    flat = [t.reshape((-1,) + t.shape[len(batch_shape):]) for t in tensors]
    size = max(1, INDICATOR_CHUNK_ELEMENTS // elements_per_sample)
    out = torch.cat([fn(*(t[i:i + size] for t in flat))
                     for i in range(0, max(flat[0].shape[0], 1), size)])
    return out.reshape(batch_shape + out.shape[1:])


def fracture_indicator(segments, n, box=((0.0, 0.0), (1.0, 1.0)), aperture=0.0):
    """[..., n, n] mask (1.0 / 0.0 in the segments' dtype) of the grid cells
    crossed by a fracture.

    A cell counts as fractured when its center lies within
    ``max(aperture, h) / 2`` of a segment (a fracture is always at least
    one cell wide: the coarse grid's inability to resolve thin fractures is
    the discretization error MLMC telescopes over).
    """
    (cx, cy), h = _cell_centers(box, n, segments.dtype, segments.device)
    X, Y = torch.meshgrid(cx, cy, indexing="ij")
    pts = torch.stack([X.reshape(-1), Y.reshape(-1)], dim=1)
    radius = max(aperture, h) * 0.5
    F = segments.shape[-3]

    def one(seg):
        return (fracture_min_distance(seg, pts) <= radius).to(seg.dtype)

    batch_shape = segments.shape[:-3]
    ind = _by_sample_chunks(one, [segments], batch_shape, n * n * F * 2)
    return ind.reshape(batch_shape + (n, n))


def fracture_conductivity(segments, n, bulk_K, contrast,
                          box=((0.0, 0.0), (1.0, 1.0)), aperture=0.0):
    """Bulk conductivity boosted multiplicatively inside fractures."""
    ind = fracture_indicator(segments, n, box=box, aperture=aperture)
    return bulk_K * torch.where(ind > 0, contrast, 1.0).to(bulk_K.dtype)


class _FracturedDraws:
    """What the fractured simulations add to their bulk's draws: one
    network per sample, drawn after the field (from the generator) or on
    the calls of its own (keyed), and rasterized on every grid the sample
    solves. A class says ``DIM``, ``_network(config, draws)`` and
    ``_rasterize(config, network, n, bulk)``."""

    @classmethod
    def _conductivity(cls, config, n, network=None, **field_draws):
        """The bulk conductivity of the field draws (``noise`` / ``phases``)
        with ``network`` rasterized at n."""
        if network is None:
            raise ValueError(
                "fractured conductivity has geometry randomness beyond the "
                "field phases (pass network=); no QMC parametrization")
        bulk = super()._conductivity(config, n, **field_draws)
        return cls._rasterize(config, network, n, bulk)

    @classmethod
    def _normal_orientations(cls, config):
        """2-D angles are normal when concentrated (3-D normals always are)."""
        return config.get("frac_concentration", 0.0) > 0

    @classmethod
    def _sample_draws(cls, config, generator, n, device):
        draws = super()._sample_draws(config, generator, n, device)
        draws["network"] = cls._network(config, fracture_draws(
            generator, config.get("n_fractures", 24), cls.DIM,
            cls._normal_orientations(config), batch=int(n), device=device,
            dtype=config_dtype(config)))
        return draws

    @classmethod
    def _keyed_draws(cls, config, seed, level_id, indices, attempts):
        draws = super()._keyed_draws(config, seed, level_id, indices, attempts)
        draws["network"] = cls._network(config, keyed_fracture_draws(
            seed, level_id, indices, attempts, config.get("n_fractures", 24),
            cls.DIM, cls._normal_orientations(config), config_dtype(config)))
        return draws


class FracturedDiffusionSimulation(_FracturedDraws, DiffusionSimulation):
    """Darcy flow through a fractured medium: a fracture network
    rasterized into the log-normal bulk conductivity.

    Config keys (on top of DiffusionSimulation's):
      n_fractures (default 24), frac_contrast (default 1e3),
      frac_size_range, frac_power, frac_mean_angle, frac_concentration,
      frac_aperture (physical; cells are at least one h wide).
    """

    # 1e3-contrast channels put eigenvalue clusters beyond any diagonal or
    # spectral scaling's reach; the multigrid V-cycle's coarse-space
    # correction removes them, so MG is the class default, and the spectral
    # cap stays raised for users who override precond
    PRECOND = "mg"
    CG_MAXITER_FACTOR = 32
    DIM = 2

    @classmethod
    def _network(cls, config, draws):
        return sample_fracture_network(
            draws, n_fractures=config.get("n_fractures", 24),
            size_range=config.get("frac_size_range", (0.1, 0.5)),
            power=config.get("frac_power", 1.8),
            mean_angle=config.get("frac_mean_angle", 0.0),
            concentration=config.get("frac_concentration", 0.0))

    @classmethod
    def _rasterize(cls, config, network, n, bulk):
        return fracture_conductivity(
            network, n, bulk, contrast=config.get("frac_contrast", 1e3),
            aperture=config.get("frac_aperture", 0.0))


# ===================================================================== #
# 3-D fracture networks: penny-shaped discs
# ===================================================================== #
def sample_fracture_network_3d(draws, n_fractures,
                               box=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                               size_range=(0.1, 0.6), power=2.2,
                               mean_normal=None, concentration=0.0):
    """Random 3-D fracture set as penny-shaped discs: centers uniform in the
    box, radii truncated-Pareto (``power`` is the exponent of the RADIUS
    law), normals uniform on the sphere, or concentrated around
    ``mean_normal`` (a normal perturbation with std 1/sqrt(concentration),
    renormalized).

    :param draws: ``FractureDraws`` or a ``torch.Generator``
    :return: (centers [..., F, 3], normals [..., F, 3] unit, radii [..., F])
    """
    if isinstance(draws, torch.Generator):
        draws = fracture_draws(draws, n_fractures, 3, dtype=torch.float64)
    if draws.centers.shape[-2] != n_fractures:
        raise ValueError("the draws hold %d fractures, not %d"
                         % (draws.centers.shape[-2], n_fractures))
    centers = _in_box(draws.centers, box)
    radii = 0.5 * _truncated_pareto(draws.sizes, size_range, power)
    normals = draws.orientations
    if mean_normal is not None and concentration > 0:
        mu = torch.as_tensor(mean_normal, dtype=normals.dtype, device=normals.device)
        mu = mu / torch.linalg.norm(mu)
        normals = mu + normals / np.sqrt(concentration)
    norm = torch.sqrt(normals[..., 0] * normals[..., 0] + normals[..., 1] * normals[..., 1]
                      + normals[..., 2] * normals[..., 2])
    normals = normals / torch.clamp(norm, min=1e-30)[..., None]
    return centers, normals, radii


def fracture_indicator_3d(discs, n, box=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                          aperture=0.0):
    """[..., n, n, n] mask of the grid cells crossed by a disc: a cell
    counts when its center lies within ``max(aperture, h) / 2`` of the disc
    plane AND inside the disc radius in-plane (a fracture is at least one
    cell thick, as in 2-D)."""
    centers, normals, radii = discs
    (cx, cy, cz), h = _cell_centers(box, n, centers.dtype, centers.device)
    X, Y, Z = torch.meshgrid(cx, cy, cz, indexing="ij")
    pts = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], dim=1)
    thick = max(aperture, h) * 0.5
    F = centers.shape[-2]

    def one(c, nrm, rad):
        rel = pts[:, None, :] - c[..., None, :, :]          # [b, P, F, 3]
        nb = nrm[..., None, :, :]
        dist_n = rel[..., 0] * nb[..., 0] + rel[..., 1] * nb[..., 1] \
            + rel[..., 2] * nb[..., 2]                       # signed normal
        inplane2 = (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
                    + rel[..., 2] * rel[..., 2]) - dist_n ** 2
        hit = (dist_n.abs() <= thick) & (inplane2 <= (rad ** 2)[..., None, :])
        return hit.any(dim=-1).to(c.dtype)

    batch_shape = centers.shape[:-2]
    ind = _by_sample_chunks(one, [centers, normals, radii], batch_shape, n ** 3 * F * 3)
    return ind.reshape(batch_shape + (n, n, n))


def fracture_conductivity_3d(discs, n, bulk_K, contrast,
                             box=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                             aperture=0.0):
    """Bulk conductivity boosted multiplicatively inside fractures."""
    ind = fracture_indicator_3d(discs, n, box=box, aperture=aperture)
    return bulk_K * torch.where(ind > 0, contrast, 1.0).to(bulk_K.dtype)


class FracturedDiffusionSimulation3D(_FracturedDraws, DiffusionSimulation3D):
    """3-D Darcy flow through a fractured medium: penny-shaped disc
    networks rasterized into the log-normal bulk conductivity, solved under
    the 3-D multigrid V-cycle (the exact Galerkin coarse transmissibilities
    keep the fracture channels on the coarse interfaces).

    Config keys (on top of DiffusionSimulation3D's):
      n_fractures (default 24), frac_contrast (default 1e3),
      frac_size_range, frac_power, frac_mean_normal,
      frac_concentration, frac_aperture.
    """

    PRECOND = "mg"
    CG_MAXITER_FACTOR = 32
    DIM = 3

    @classmethod
    def _network(cls, config, draws):
        return sample_fracture_network_3d(
            draws, n_fractures=config.get("n_fractures", 24),
            size_range=config.get("frac_size_range", (0.15, 0.6)),
            power=config.get("frac_power", 2.2),
            mean_normal=config.get("frac_mean_normal"),
            concentration=config.get("frac_concentration", 0.0))

    @classmethod
    def _rasterize(cls, config, network, n, bulk):
        return fracture_conductivity_3d(
            network, n, bulk, contrast=config.get("frac_contrast", 1e3),
            aperture=config.get("frac_aperture", 0.0))


# ===================================================================== #
# the reference's geomop mesh path: descoped
# ===================================================================== #
def make_frac_mesh(box, mesh_step, fractures, frac_step):
    """DESCOPED: the reference's geomop-bridge mesh builder (reference
    mlmc/random/frac_geom.py:17-30). It drives the external ``geomop``
    package and the ``gmsh`` binary, which no supported environment has;
    fractured media run through ``FracturedDiffusionSimulation(3D)``, and a
    mesh built elsewhere loads through ``mlmc_tpu_torch.tool.gmsh_io.GmshIO``
    and runs through ``FlowSim``."""
    raise ImportError(
        "make_frac_mesh is descoped: it requires the external 'geomop' "
        "package + gmsh binary (reference mlmc/random/frac_geom.py:17-30), "
        "which are not installable. Use FracturedDiffusionSimulation "
        "(device-native) or load a pre-built mesh via "
        "mlmc_tpu_torch.tool.gmsh_io.GmshIO.")
