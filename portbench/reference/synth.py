"""The synthetic simulation of GeoMop/MLMC (``mlmc/sim/synth_simulation.py``)
in plain PyTorch: a parameter y ~ N(0, 1) and the QoI y + h sqrt(1e-4 + |y|)
at step h, fine and coarse sharing the draw.

Two ways of drawing y, as the program under test does:

* the storage-free estimate: sample i of level l is the quad-stream normal
  (``philox.quad_normals``) of (seed, l, i);
* a stored run: sample (l, i) draws its two y values by one Philox call
  (``philox.pair_normals``), and its result is the 24-value record of the
  upstream format: two quantities (length, width) x three times x two
  locations x a (2, 1) shape; location k adds k to the QoI, except on
  level 0, whose coarse part is zero.
"""
import torch

from reference import moments, philox

N_TIMES, N_LOCATIONS, N_VALUES = 3, 2, 2
#: values of one quantity of the record (times x locations x shape)
QUANTITY_SIZE = N_TIMES * N_LOCATIONS * N_VALUES


def qoi(y, h, values):
    """y + h sqrt(1e-4 + |y|) in the ``values`` dtype, each operation
    rounded once (the square root through float64, which rounds float32
    correctly)."""
    y = y.to(values)
    a = moments.as_value(1e-4, values) + torch.abs(y)
    root = torch.sqrt(a.double()).to(values) if values == torch.float32 else torch.sqrt(a)
    return y + moments.as_value(h, values) * root


def fused_level_sums(seed, n_per_level, steps, n_moments, domain, values, acc,
                     device, chunk=moments.CHUNK):
    """Host accumulators of every level of the storage-free estimate, drawn
    from the quad stream; the domain maps symmetrically onto [-1, 1]."""
    consts = moments.transform(domain, values, symmetric=True)
    out = []
    for lvl, n in enumerate(n_per_level):
        total = moments.empty_sums(n_moments, acc, device)
        for s in range(0, int(n), chunk):
            y = philox.quad_normals(seed, lvl, s, min(chunk, int(n) - s), device)
            t_f, ok = moments.map_values(qoi(y, steps[lvl], values), consts, values)
            t_c = None
            if lvl:
                t_c, ok_c = moments.map_values(qoi(y, steps[lvl - 1], values),
                                               consts, values)
                ok = ok & ok_c
            moments.add_rows(total, t_f, t_c, ok, n_moments, acc)
        out.append(moments.to_host(total, acc))
    return out


def record_values(seed, level, indices, steps, components, values):
    """(fine, coarse) [B, len(components)] of the stored records of samples
    ``indices`` (int64 tensor) on ``level``; coarse is None on level 0.
    Component c counts through quantity, time, location and shape, in that
    order (the 24 values of a record)."""
    y = philox.pair_normals(seed, level, indices, N_VALUES)
    fine = qoi(y, steps[level], values)
    coarse = qoi(y, steps[level - 1], values) if level else None
    cols_f, cols_c = [], []
    for c in components:
        location = (c % QUANTITY_SIZE) // N_VALUES % N_LOCATIONS
        value = c % N_VALUES
        offset = location if level else 0
        cols_f.append(fine[:, value] + offset)
        if coarse is not None:
            cols_c.append(coarse[:, value] + offset)
    return (torch.stack(cols_f, dim=1),
            torch.stack(cols_c, dim=1) if coarse is not None else None)
