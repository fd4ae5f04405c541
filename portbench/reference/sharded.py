"""The storage-free estimate split over the shards of a sample mesh, in
plain PyTorch and NumPy: shard s of D reduces sample indices
[s n_l / D, (s + 1) n_l / D) of each level l, drawn from the quad stream
(``philox.quad_normals``), mapped by ``synth.qoi`` and reduced by
``moments``, the same steps as ``synth.fused_level_sums``; the shards'
sums are then added in shard order.
"""
from reference import moments, philox, synth


def shard_ranges(n_per_level, n_shards, shard):
    """[(lo, hi)] of each level: the equal share of shard ``shard``."""
    return [(shard * int(n) // n_shards, (shard + 1) * int(n) // n_shards)
            for n in n_per_level]


def range_level_sums(seed, ranges, steps, n_moments, domain, values, acc, device,
                     chunk=moments.CHUNK):
    """Host accumulators of each level l over its sample indices
    [ranges[l][0], ranges[l][1]); the domain maps symmetrically onto
    [-1, 1]."""
    consts = moments.transform(domain, values, symmetric=True)
    out = []
    for lvl, (lo, hi) in enumerate(ranges):
        total = moments.empty_sums(n_moments, acc, device)
        for s in range(int(lo), int(hi), chunk):
            y = philox.quad_normals(seed, lvl, s, min(chunk, int(hi) - s), device)
            t_f, ok = moments.map_values(synth.qoi(y, steps[lvl], values), consts, values)
            t_c = None
            if lvl:
                t_c, ok_c = moments.map_values(synth.qoi(y, steps[lvl - 1], values),
                                               consts, values)
                ok = ok & ok_c
            moments.add_rows(total, t_f, t_c, ok, n_moments, acc)
        out.append(moments.to_host(total, acc))
    return out


def add_shards(per_shard):
    """Each level's accumulators summed over the shards, in shard order
    (``per_shard[s][l]`` is shard s's level l)."""
    out = []
    for lvl in range(len(per_shard[0])):
        total = dict(per_shard[0][lvl])
        for shard in per_shard[1:]:
            for key in total:
                total[key] = total[key] + shard[lvl][key]
        out.append(total)
    return out
