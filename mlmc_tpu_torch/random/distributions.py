"""Sampling distributions driven by explicit ``torch.Generator``s.

Counterpart of ``mlmc_tpu/random/distributions.py``. Each distribution is
a small frozen spec with ``sample(generator, shape, device)``. This slice
carries ``Norm``.
"""
import dataclasses

import torch


class TorchDistr:
    """Base: generator-driven sampler."""

    def sample(self, generator, shape=(), device=None, dtype=torch.float64):
        """Draw variates of ``shape`` from ``generator`` on ``device``
        (the generator must live on the same device)."""
        raise NotImplementedError

    def from_standard_normals(self, z):
        """Variates from standard normals ``z`` (counter-based draws)."""
        raise NotImplementedError(
            "{} has no map from standard normals".format(type(self).__name__))


@dataclasses.dataclass(frozen=True)
class Norm(TorchDistr):
    loc: float = 0.0
    scale: float = 1.0

    def sample(self, generator, shape=(), device=None, dtype=torch.float64):
        z = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return self.loc + self.scale * z

    def from_standard_normals(self, z):
        return self.loc + self.scale * z


def as_torch_distr(distr):
    """Coerce a name, a scipy frozen normal or a TorchDistr to a TorchDistr."""
    if isinstance(distr, TorchDistr):
        return distr
    if isinstance(distr, str):
        if distr.lower() == "norm":
            return Norm()
        raise ValueError("Unknown distribution name: {}".format(distr))
    dist_name = getattr(getattr(distr, "dist", None), "name", None)
    if dist_name == "norm":
        return Norm(float(distr.mean()), float(distr.std()))
    raise ValueError(
        "Cannot map {} onto a torch sampler; pass a TorchDistr".format(distr))
