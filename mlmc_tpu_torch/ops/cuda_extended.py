"""The f64 estimation tier over stored samples (counterpart of
``mlmc_tpu/ops/pallas_extended.py``).

The TPU has no f64, so ``mlmc_tpu`` computes this tier in double-float
(pairs of f32). Hopper has native f64: kernel D (``samples_ext_cuda``,
``csrc/samples_mlmc.cu``) is kernel C with the domain transform and the
basis rows in f64, and the sums in f64 as in every kernel of this package.
Its Grams run on the FP64 tensor cores through the same code as kernel C's
(``csrc/moment_gram.cuh``). On identical f32 QoIs it tracks the all-f64
reference (``ops/precision.f64_reference_moments_strict``) within
``ops/precision.extended_error_bound``, about 1.8e-13 * S_abs.

``symmetric`` selects the transform of the strict reference,
t = (x - (a + b)/2) * scale, instead of t = (x - a) * scale + ref_lo.
Results come back to the host as f64 numpy arrays, as in ``mlmc_tpu``.
"""
from typing import NamedTuple

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops import cuda_kernels as ck


class ExtendedMomentResult(NamedTuple):
    """Host-side f64 accumulators; fields mirror SynthMomentResult."""

    sums: np.ndarray        # [R] f64
    sums2: np.ndarray       # [R] f64
    cov_fine: np.ndarray    # [R, R] f64
    cov_coarse: np.ndarray  # [R, R] f64
    n_valid: int


def samples_ext_cuda(streams, n_moments, *, basis, consts, device):
    """Launch kernel D: every stream's accumulators in one launch.

    :param consts: f64 ``transform_constants``
    :return: stacked SynthMomentResult [S, ...] (float64, int64 counts)
    """
    out = ck._samples_launch("samples_ext_launch", streams, n_moments, basis,
                             consts, device)
    samples_ext_cuda.launches += 1
    return out


samples_ext_cuda.launches = 0


def samples_ext_plain(streams, n_moments, *, basis, consts, absolute=False):
    """Plain version of kernel D (f64 transform, rows and sums)."""
    return ck.samples_plain(streams, n_moments, basis=basis, consts=consts,
                            f64=True, absolute=absolute)


def launch_counts():
    """Launches of kernel D since the last reset."""
    return {"samples_ext": samples_ext_cuda.launches}


def reset_launch_counts():
    samples_ext_cuda.launches = 0


def samples_ext_moments(streams, n_moments, *, domain, ref_domain=(-1.0, 1.0),
                        basis="legendre", symmetric=False):
    """Kernel D for streams on a CUDA device, its plain version for
    streams on the CPU; stacked SynthMomentResult [S, ...]."""
    ck._check_basis(basis, n_moments)
    consts = ck.transform_constants(domain, ref_domain, f64=True,
                                    symmetric=symmetric)
    if streams.fine.device.type == "cuda":
        return samples_ext_cuda(streams, n_moments, basis=basis,
                                consts=consts, device=streams.fine.device)
    return samples_ext_plain(streams, n_moments, basis=basis, consts=consts)


def to_host(stacked, s=0):
    """Stream ``s`` of a stacked result as an ExtendedMomentResult."""
    fields = [getattr(stacked, f)[s].cpu().numpy()
              for f in ("sums", "sums2", "cov_fine", "cov_coarse")]
    return ExtendedMomentResult(*fields, int(stacked.n_valid[s]))


def moment_pipeline_from_samples_extended(fine, coarse, n_moments, *, domain,
                                          ref_domain=(-1.0, 1.0),
                                          basis="legendre", is_level0=False,
                                          symmetric=False, device=None):
    """f64 stored-samples moment accumulators of one level (kernel D).

    Same contract as ``cuda_kernels.moment_pipeline_from_samples``: NaN
    and out-of-domain samples are dropped; values are read as f32.

    :param device: defaults to the device of ``fine`` (the current CUDA
        device for numpy input)
    :return: ExtendedMomentResult (host f64)
    """
    device = resolve_device(device, like=fine)
    f = ck._as_f32_tensor(fine, device)
    c = None if is_level0 or coarse is None else ck._as_f32_tensor(coarse,
                                                                   device)
    streams = ck.pack_streams([f], [c], [not is_level0])
    return to_host(samples_ext_moments(
        streams, int(n_moments), domain=domain, ref_domain=ref_domain,
        basis=basis, symmetric=symmetric))


def synth_moment_pipeline_from_noise_extended(noise, n_moments, *,
                                              fine_step, coarse_step, domain,
                                              is_level0=False, device=None):
    """The f64 tier of the synthetic level from normals ``noise``: the QoIs
    x + h*sqrt(1e-4 + |x|) in f32 (correctly rounded square root), then
    kernel D with the symmetric Legendre transform.

    :return: ExtendedMomentResult (host f64)
    """
    device = resolve_device(device, like=noise)
    x = ck._as_f32_tensor(noise, device)
    err = ck._sqrt_f32(ck._ERR_FLOOR_F32 + torch.abs(x))
    fine = x + ck._f32(fine_step) * err
    coarse = x + ck._f32(coarse_step) * err
    return moment_pipeline_from_samples_extended(
        fine, coarse, n_moments, domain=domain, basis="legendre",
        is_level0=is_level0, symmetric=True, device=device)
