"""Where the storage-free headline's device time goes, on one GPU.

Run from the root of a checkout:

    python3 -m mlmc_tpu_torch.tool.profile_headline

Prints the card's ``nvidia-smi`` name and power limit, then

1. ``torch.profiler`` over 5 warm back-to-back headline calls
   (``synth_mlmc_pipeline``: 1e8 samples, 5 levels, 25 Legendre moments on
   (-4, 4)): device time per call of the main kernel, of the per-level
   reduce kernel and of the host-to-device table copies, and the device's
   idle share of the span from the first device event to the last;
2. CUDA-event times (median of 5 warm calls) per 2^26 samples of one
   level: level 0, a level with a coarse part in RNG mode, in memory mode
   and at R=8, and kernel B writing 2^26 normals;
3. the SM clock, power draw, power limit and temperature after the runs.
"""
import subprocess

import numpy as np
import torch

from mlmc_tpu_torch.ops import cuda_kernels as ck

SEED = 2024
N_MOMENTS = 25
DOMAIN = (-4.0, 4.0)
LEVEL_STEPS = [0.5, 0.25, 0.125, 0.0625, 0.03125]
N_PER_LEVEL = [64_000_000, 24_000_000, 8_000_000, 3_000_000, 1_000_000]
N_CALLS = 5
N_LEVEL = 1 << 26


def _smi(query):
    out = subprocess.run(["nvidia-smi", "--query-gpu=" + query,
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or "nvidia-smi: " + out.stderr.strip()


def _median_ms(fn, reps=5):
    """Median over ``reps`` warm calls, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _group(name):
    for key in ("synth_mlmc_kernel", "gram_reduce", "Memcpy HtoD"):
        if key in name:
            return key
    return name


def device_breakdown(device):
    """Profile ``N_CALLS`` warm headline calls; print the device time per
    call of each kernel or copy and the device's idle share."""
    def headline():
        ck.synth_mlmc_pipeline(SEED, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS,
                               domain=DOMAIN, device=device)

    headline()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(N_CALLS):
            headline()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise SystemExit("profile_headline: the profiler saw no device events")
    totals = {}
    for e in events:
        key = _group(e.name)
        n, us = totals.get(key, (0, 0.0))
        totals[key] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in totals.values())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    print("torch.profiler, %d warm headline calls (1e8 samples, 5 levels, R=%d):"
          % (N_CALLS, N_MOMENTS))
    for key, (n, us) in sorted(totals.items(), key=lambda kv: -kv[1][1]):
        print("  %-20s %3d events, %10.3f ms per call, %6.2f%% of device time"
              % (key, n, us / N_CALLS / 1e3, 100.0 * us / busy))
    print("  device busy %.3f ms over a span of %.3f ms: idle %.2f%%"
          % (busy / 1e3, span / 1e3, 100.0 * (1.0 - busy / span)))


def per_level_times(device):
    """CUDA-event times of one level's 2^26 samples in each mode."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(N_LEVEL, generator=gen, device=device)
    coarse = dict(fine_step=0.25, coarse_step=0.5, domain=DOMAIN)
    cases = [
        ("level 0, RNG mode", lambda: ck.synth_moment_pipeline(
            SEED, N_MOMENTS, N_LEVEL, fine_step=0.5, coarse_step=0.0,
            domain=DOMAIN, is_level0=True, device=device)),
        ("coarse part, RNG mode", lambda: ck.synth_moment_pipeline(
            SEED, N_MOMENTS, N_LEVEL, device=device, **coarse)),
        ("coarse part, memory mode", lambda: ck.synth_moment_pipeline_from_noise(
            x, N_MOMENTS, **coarse)),
        ("coarse part, R=8, RNG mode", lambda: ck.synth_moment_pipeline(
            SEED, 8, N_LEVEL, device=device, **coarse)),
        ("kernel B, normals", lambda: ck.synth_normals(
            SEED, N_LEVEL, device=device)),
    ]
    print("CUDA events, median of 5 warm calls, per 2^26 samples:")
    for label, fn in cases:
        print("  %-28s %.3f ms" % (label, _median_ms(fn)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_headline: needs a CUDA device")
    device = torch.device("cuda", 0)
    print(_smi("name,power.limit"))
    device_breakdown(device)
    per_level_times(device)
    print("after the runs (clocks.sm, power.draw, power.limit, temperature): "
          + _smi("clocks.current.sm,power.draw,power.limit,temperature.gpu"))


if __name__ == "__main__":
    main()
