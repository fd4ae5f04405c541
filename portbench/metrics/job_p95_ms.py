"""95th percentile of the wall of every job in the window (linear
interpolation between order statistics)."""
import numpy as np


def read(run):
    if not run.records:
        return None
    return 1e3 * float(np.percentile([r["wall"] for r in run.records], 95))
