"""Precisions and the gaps that decide ``correct``.

A configuration states the precision of its per-sample values and of its
sums. The plain reference computes in those precisions; the control is the
same reference one step lower in each (float64 -> float32, float32 ->
bfloat16), put in the program's place.
"""
import numpy as np

LOWER = {"float64": "float32", "float32": "bfloat16"}


def precision(config, control=False):
    """(values dtype, sums dtype) as torch dtypes."""
    import torch

    names = [config["precision"]["values"], config["precision"]["sums"]]
    if control:
        names = [LOWER[n] for n in names]
    return tuple(getattr(torch, n) for n in names)


def abs_gap(got, want):
    """Largest |got - want|."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def rel_gap(got, want, floor=0.0):
    """Largest |got - want| / max(|want|, floor); infinite where either side
    is not finite."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if not (np.all(np.isfinite(got)) and np.all(np.isfinite(want))):
        return float("inf")
    scale = np.maximum(np.abs(want), floor)
    return float(np.max(np.abs(got - want) / scale)) if got.size else 0.0


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        ok = ok and bool(np.isfinite(value)) and value <= limit
        rows.append((name, value, limit))
    return ok, rows
