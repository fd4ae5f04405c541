"""A simulation for the pool tests that reports where it ran. It lives in
a module of its own, which imports nothing heavy, so that a spawned worker
process that unpickles it starts quickly."""
import os

import numpy as np
import torch

import mlmc_tpu_torch as mt


class ProbeSimulation(mt.SynthSimulation):
    """Reports, from inside the worker, the process id, whether CUDA was
    initialised there, and the device ``calculate`` was handed."""

    @staticmethod
    def calculate(config, seed, device=None):
        row = np.zeros(24)
        row[0] = os.getpid()
        row[1] = float(torch.cuda.is_initialized())
        row[2] = {"cpu": 1.0, None: 0.0}.get(device, -1.0)
        value = torch.zeros(3, device=device).sum()      # computes where told
        row[3] = float(value.device.type == "cpu")
        return row, row.copy()
