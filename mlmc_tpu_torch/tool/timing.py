"""Two ways of timing a call on the card with CUDA events, and the card's
own report (``smi``) to print beside every time.

``event_ms`` times single calls: one event before the call, one after. The
span holds the host's launch path as well as the device's work, since the
device waits for the host between the two. ``queued_ms`` times the device
alone: the calls are queued behind a spin kernel, so the host has enqueued
them all before the device starts the first, and they run back to back.
For a call of a few tens of microseconds the two differ by the host path.
"""
import subprocess

import numpy as np
import torch


def smi(query):
    """The first card's answer to ``nvidia-smi --query-gpu=<query>`` (e.g.
    ``"name,power.limit"``), or the tool's error."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=" + query,
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi: " + out.stderr.strip()


def event_ms(fn, reps=5):
    """Median over ``reps`` warm single calls, each between two events."""
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


def queued_ms(fn, reps=20, rounds=5):
    """Device time per call: ``reps`` calls queued behind a spin kernel,
    timed with events; median over ``rounds``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(1 << 24)  # ~10 ms of one thread spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))
