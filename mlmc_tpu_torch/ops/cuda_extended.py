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
Kernel D is reached, as kernel C, through ``cuda_kernels.samples_moments``
(``f64=True``). Results come back to the host as f64 numpy arrays, as in
``mlmc_tpu``.
"""
from typing import NamedTuple

import numpy as np

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
    out = ck.samples_launch("samples_ext_launch", streams, n_moments, basis,
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
    streams = ck.level_stream(fine, coarse, is_level0=is_level0, device=device)
    return to_host(ck.samples_moments(
        streams, int(n_moments), domain=domain, ref_domain=ref_domain,
        basis=basis, f64=True, symmetric=symmetric))


def synth_moment_pipeline_from_noise_extended(noise, n_moments, *,
                                              fine_step, coarse_step, domain,
                                              is_level0=False, device=None):
    """The f64 tier of the synthetic level from normals ``noise``: the QoIs
    of ``cuda_kernels.synth_qoi`` (f32), then kernel D with the symmetric
    Legendre transform.

    :return: ExtendedMomentResult (host f64)
    """
    device = resolve_device(device, like=noise)
    fine, coarse = ck.synth_qoi(ck.as_f32_tensor(noise, device), fine_step,
                                coarse_step)
    return moment_pipeline_from_samples_extended(
        fine, coarse, n_moments, domain=domain, basis="legendre",
        is_level0=is_level0, symmetric=True, device=device)
