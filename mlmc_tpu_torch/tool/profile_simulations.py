"""Where a simulation batch's time goes, on one GPU.

Run from the root of a checkout:

    python3 -m mlmc_tpu_torch.tool.profile_simulations

Prints the card's ``nvidia-smi`` name and power limit, then for the
shooting batch (8192 coupled samples, 256 modes, 1000 + 200 Euler steps)
and the Darcy batch (1024 coupled samples, 64^2 + 16^2 grids, circulant
GRF) of ``chip_smoke.py``:

1. ``torch.profiler`` over warm back-to-back ``calculate_batch`` calls:
   device events per batch, the device's busy time per batch and its idle
   share of the span from the first device event to the last, and the
   kernels that take most of the device time; the same for the 3-D Darcy
   batch (256 samples, 32^3 + 16^3, spectral CG) and the 3-D and 2-D
   fractured batches of ``chip_smoke.py`` (64 samples at 32^3 + 16^3, 1024
   at 64^2 + 16^2, 24 fractures, multigrid CG);
2. the Darcy batch by CUDA events at several values of the solver's
   ``CG_CHECK_EVERY`` (how often the host asks whether any sample still
   iterates), with the iteration counts, which must not change;
3. the pool's path, ``calculate_keyed_batch`` at 64^2 / 32^2: the time of
   the keyed normals alone and of the whole batch at 4096 samples, and the
   peak device memory of one batch of 2^14 samples (the adaptive loop's
   ``max_batch``);
4. what tracing the host costs: one 3-D Darcy batch under
   ``torch.profiler`` with the host's operators and the device traced, and
   with the device alone (the host time of the call and of reading the
   events, and the idle share each reports);
5. the coupling of the 3-D fractured batch (32^3 + 16^3, 24 discs,
   contrast 1e3): Var(fine - coarse) / Var(fine) and corr(fine, coarse)
   over 8 keyed batches of 64 samples, batch by batch and over all 512.
"""
import time

import numpy as np
import torch

from mlmc_tpu_torch.random.frac_geom import (FracturedDiffusionSimulation,
                                             FracturedDiffusionSimulation3D)
from mlmc_tpu_torch.random.keyed import keyed_normals
from mlmc_tpu_torch.sim import diffusion
from mlmc_tpu_torch.sim.diffusion import DiffusionSimulation
from mlmc_tpu_torch.sim.diffusion3d import DiffusionSimulation3D
from mlmc_tpu_torch.sim.shooting import ShootingSimulation1D
from mlmc_tpu_torch.tool.timing import smi

SEED = 2024


def _mean_ms(fn, reps):
    """Mean over ``reps`` warm back-to-back calls, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(label, fn, n_calls, top=6):
    """Profile ``n_calls`` warm calls of ``fn``; print the device's busy
    and idle share and its largest kernels. Only the device is traced:
    tracing the host's operators as well slows the host, which raises the
    idle share, and makes the events slower to read (``tracing_cost``
    measures both).

    :return: dict(events_per_call, busy_ms, span_ms, idle_share), per call
    """
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise SystemExit("profile_simulations: the profiler saw no device events")
    totals = {}
    for e in events:
        n, us = totals.get(e.name, (0, 0.0))
        totals[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in totals.values())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    print("torch.profiler, %d warm calls of %s: %.0f device events per call, "
          "device busy %.3f ms per call over a span of %.3f ms per call: idle %.2f%%"
          % (n_calls, label, len(events) / n_calls, busy / n_calls / 1e3,
             span / n_calls / 1e3, 100.0 * (1.0 - busy / span)))
    for name, (n, us) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:top]:
        print("  %6.2f%% of device time, %5.0f events per call: %s"
              % (100.0 * us / busy, n / n_calls, name[:100]))
    return dict(events_per_call=len(events) / n_calls, busy_ms=busy / n_calls / 1e3,
                span_ms=span / n_calls / 1e3, idle_share=1.0 - busy / span)


def device_activity(fn):
    """Run ``fn`` once under ``torch.profiler`` with only the device traced
    and read the raw device records (kineto's, without building the
    per-event Python objects, which costs seconds per 1e5 events).

    :return: (fn's result, dict(wall_s: host seconds of the traced call
        ending in a synchronize, events, busy_ms, span_ms, idle_share))
    """
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda]
    if not spans:
        raise SystemExit("device_activity: the profiler saw no device events")
    busy = sum(d for _, d in spans)
    span = max(s + d for s, d in spans) - min(s for s, _ in spans)
    return result, dict(wall_s=wall, events=len(spans), busy_ms=busy / 1e6,
                        span_ms=span / 1e6, idle_share=1.0 - busy / max(span, 1))


def tracing_cost(label, fn):
    """One warm call of ``fn`` traced with the host's operators and the
    device, then with the device alone: host seconds of the call and of
    reading the events, device events and idle share."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    for activities in ([act.CPU, act.CUDA], [act.CUDA]):
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        t2 = time.perf_counter()
        busy = sum(e.time_range.elapsed_us() for e in events)
        span = (max(e.time_range.end for e in events)
                - min(e.time_range.start for e in events))
        print("%s traced (%s): the call %.3f s, reading the events %.3f s; %d device "
              "events, idle %.2f%%" % (label, " + ".join(a.name for a in activities),
                                       t1 - t0, t2 - t1, len(events),
                                       100.0 * (1.0 - busy / span)))


def fractured_coupling(cls, cfg, n_batches, B, seed=SEED):
    """Var(fine - coarse) / Var(fine) of keyed batches (samples (seed,
    level 1, index)), batch by batch and over all of them."""
    dev = torch.device("cuda", 0)
    fines, coarses = [], []
    for b in range(n_batches):
        idx = torch.arange(B * b, B * (b + 1), device=dev)
        f, c, _ = cls.calculate_keyed_batch(cfg, seed, 1, idx, torch.zeros_like(idx))
        f, c = f[:, 0].double().cpu().numpy(), c[:, 0].double().cpu().numpy()
        fines.append(f)
        coarses.append(c)
        print("  batch %d: Var(fine) %.4f, Var(coarse) %.4f, Var(fine - coarse) %.4f: "
              "ratio %.3f; max |fine - coarse| %.3f"
              % (b, f.var(), c.var(), (f - c).var(), (f - c).var() / f.var(),
                 np.abs(f - c).max()))
    f, c = np.concatenate(fines), np.concatenate(coarses)
    print("  all %d: Var(fine) %.4f, Var(coarse) %.4f, Var(fine - coarse) %.4f: ratio %.3f; "
          "corr(fine, coarse) %.3f; mean fine %.4f, coarse %.4f"
          % (len(f), f.var(), c.var(), (f - c).var(), (f - c).var() / f.var(),
             np.corrcoef(f, c)[0, 1], f.mean(), c.mean()))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_simulations: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    shoot = ShootingSimulation1D(dict(
        start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
        area_borders=(-100.0, 200.0, -300.0, 400.0), max_time=10.0,
        complexity=20.0, n_modes=256,
        fields_params=dict(model="gauss", corr_length=1.0, sigma=0.5, log=False)))
    s_cfg = shoot.level_instance([0.02], [0.1]).config_dict
    device_breakdown("the shooting batch (8192 samples)",
                     lambda: ShootingSimulation1D.calculate_batch(s_cfg, gen, 8192), 16)

    darcy = DiffusionSimulation(dict(sigma=1.0, corr_length=0.3,
                                     field_method="circulant"))
    d_cfg = darcy.level_instance([1 / 64], [1 / 16]).config_dict
    device_breakdown("the Darcy batch (1024 samples)",
                     lambda: DiffusionSimulation.calculate_batch(d_cfg, gen, 1024), 4)

    d3 = DiffusionSimulation3D(dict(sigma=1.0, corr_length=0.3))
    d3_cfg = d3.level_instance([1 / 32], [1 / 16]).config_dict
    device_breakdown("the 3-D Darcy batch (256 samples, 32^3 + 16^3)",
                     lambda: DiffusionSimulation3D.calculate_batch(d3_cfg, gen, 256), 2)
    f3 = FracturedDiffusionSimulation3D(dict(sigma=1.0, corr_length=0.3, n_fractures=24,
                                             frac_contrast=1e3))
    f3_cfg = f3.level_instance([1 / 32], [1 / 16]).config_dict
    device_breakdown("the 3-D fractured batch (64 samples, 32^3 + 16^3)",
                     lambda: FracturedDiffusionSimulation3D.calculate_batch(f3_cfg, gen, 64), 2)
    f2 = FracturedDiffusionSimulation(dict(sigma=1.0, corr_length=0.3, n_fractures=24,
                                           frac_contrast=1e3, field_method="circulant"))
    f2_cfg = f2.level_instance([1 / 64], [1 / 16]).config_dict
    device_breakdown("the 2-D fractured batch (1024 samples, 64^2 + 16^2)",
                     lambda: FracturedDiffusionSimulation.calculate_batch(f2_cfg, gen, 1024), 2)

    noise = torch.randn((1024, 2, 128, 128), generator=gen, device=dev)
    print("the Darcy batch by CG_CHECK_EVERY (CUDA events, mean of 8 warm calls):")
    built_in = diffusion.CG_CHECK_EVERY
    for every in (1, 2, 4, 8, 16):
        diffusion.CG_CHECK_EVERY = every
        ms = _mean_ms(lambda: DiffusionSimulation._calculate(
            d_cfg, noise=(noise[:, 0], noise[:, 1])), 8)
        _, _, it_f, it_c = DiffusionSimulation._calculate(
            d_cfg, noise=(noise[:, 0], noise[:, 1]))
        print("  every %2d: %.3f ms; CG iterations max %d / mean %.2f (64^2), max %d "
              "(16^2)" % (every, ms, int(it_f.max()), float(it_f.double().mean()),
                          int(it_c.max())))
    diffusion.CG_CHECK_EVERY = built_in
    del noise

    k_cfg = darcy.level_instance([1 / 64], [1 / 32]).config_dict
    idx = torch.arange(4096, dtype=torch.int64, device=dev)
    att = torch.zeros_like(idx)
    normals_ms = _mean_ms(lambda: keyed_normals(23, 2, idx, att, 2 * 128 * 128), 4)
    batch_ms = _mean_ms(lambda: DiffusionSimulation.calculate_keyed_batch(
        k_cfg, 23, 2, idx, att), 4)
    print("calculate_keyed_batch, 4096 samples at 64^2 / 32^2: %.3f ms, of which the "
          "keyed normals (8192 Philox calls per sample) %.3f ms" % (batch_ms, normals_ms))
    idx = torch.arange(1 << 14, dtype=torch.int64, device=dev)
    att = torch.zeros_like(idx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    ms = _mean_ms(lambda: DiffusionSimulation.calculate_keyed_batch(
        k_cfg, 23, 2, idx, att), 1)
    print("calculate_keyed_batch, 2^14 samples at 64^2 / 32^2: %.3f ms; peak device "
          "memory %.3f GB above the %.3f GB held before"
          % (ms, (torch.cuda.max_memory_allocated(dev) - start) / 1e9, start / 1e9))
    tracing_cost("the 3-D Darcy batch (256 samples)",
                 lambda: DiffusionSimulation3D.calculate_batch(d3_cfg, gen, 256))
    print("the 3-D fractured batch's coupling, 8 keyed batches of 64 samples:")
    fractured_coupling(FracturedDiffusionSimulation3D, f3_cfg, 8, 64)
    print("after the runs (clocks.sm, power.draw, power.limit, temperature): "
          + smi("clocks.current.sm,power.draw,power.limit,temperature.gpu"))


if __name__ == "__main__":
    main()
