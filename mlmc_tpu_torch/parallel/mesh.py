"""The sample mesh: sample-axis data parallelism over devices and processes.

Counterpart of ``mlmc_tpu/parallel/mesh.py``. MLMC's only communication
is the fan-out of samples and a sum of small per-level accumulators
([R], [R, R] and counts), so the mesh has one axis, ``samples``.

JAX's mesh is one program over every device in its list. Here the mesh
holds two things: this process's devices, on each of which the host
launches one shard's work, and optionally a ``torch.distributed`` process
group that spans processes (``parallel/multihost``). Shard
``rank * n_local + i`` runs on local device ``i``; ``n_devices`` counts
the shards of every process. A device may be listed more than once: each
entry is a shard of its own (two shards on one card run the real kernels
on the split).

Reductions sum the local shards on ``devices[0]`` in shard order, in f64
(floating fields) and int64 (counts), then all-reduce over the group:
NCCL for a mesh of CUDA devices, gloo for a mesh of CPU devices. The
result is the same on every shard, as JAX's ``psum`` with ``out_specs=P()``.

While a profiler records (``tool/profiling``), ``reduce`` is the span
``mesh.reduce``, each collective the span ``mesh.allreduce`` or
``mesh.allgather`` inside it; the counter ``mesh.collectives`` counts the
collective calls and ``mesh.reduce_bytes`` the bytes handed to
``all_reduce``. No span waits for the device.
"""
from typing import Optional

import torch
import torch.distributed as dist

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.tool import profiling


def backend_for(devices):
    """The collective backend a mesh of ``devices`` reduces over: NCCL for
    CUDA devices, gloo for CPU devices; a mixed list raises."""
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) != 1:
        raise ValueError("a sample mesh holds devices of one kind, got %s"
                         % sorted(kinds))
    return "nccl" if kinds == {"cuda"} else "gloo"


def _flatten(tree):
    """Leaves of a tensor or a (nested) tuple/list/NamedTuple of tensors,
    and a function that rebuilds the structure from new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    parts = [_flatten(x) for x in tree]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, pos = [], 0
        for (_, build), n in zip(parts, sizes):
            out.append(build(leaves[pos:pos + n]))
            pos += n
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)

    return [leaf for p in parts for leaf in p[0]], rebuild


class SampleMesh:
    """1-D mesh of sample shards over this process's devices and,
    optionally, the processes of a ``torch.distributed`` group.

    :param devices: this process's devices (repeats allowed); None means
        every visible CUDA device, and raises without a card
    :param group: the process group to all-reduce over; None means the
        world group when one is initialised, False means this process
        alone. Its backend must be the mesh's (NCCL for CUDA devices, gloo
        for CPU devices): a mesh never reduces over the other one
    :param axis_name: the mesh axis' name
    """

    AXIS = "samples"

    def __init__(self, devices=None, group=None, axis_name: str = AXIS):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(max(torch.cuda.device_count(), 1))]
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("a sample mesh needs at least one device")
        self.devices = devices
        self.axis_name = axis_name
        self.backend = backend_for(devices)
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group or None
        if self.group is not None:
            got = dist.get_backend(self.group)
            if got != self.backend:
                raise ValueError(
                    "a mesh of %s devices reduces over %s, but its process "
                    "group is %s" % (devices[0].type, self.backend, got))
            self.rank = dist.get_rank(self.group)
            self.world_size = dist.get_world_size(self.group)
        else:
            self.rank, self.world_size = 0, 1

    @property
    def n_local(self) -> int:
        """Shards of this process."""
        return len(self.devices)

    @property
    def n_devices(self) -> int:
        """Shards of the whole mesh (local devices times processes)."""
        return self.n_local * self.world_size

    def local_shards(self):
        """(global shard index, device) of each of this process's shards."""
        return [(self.rank * self.n_local + i, d)
                for i, d in enumerate(self.devices)]

    def batch_sharding(self):
        """The sample axis split over the shards: a function that returns
        this process's slices of an array (``shard_batch``). PyTorch has no
        sharded array type; the split is the sharding."""
        return self.shard_batch

    def replicated(self):
        """Every shard holds the whole value: a function that returns its
        argument as it is (nothing to place)."""
        return lambda x: x

    def pad_to_shards(self, n: int) -> int:
        """Round n up to a multiple of the shard count."""
        d = self.n_devices
        return -(-n // d) * d

    def check_divides(self, n, what="per-level counts"):
        """Raise unless ``n`` divides by the shard count (JAX's guard)."""
        if int(n) % self.n_devices:
            raise ValueError(
                "%s must be divisible by the device count — pad the request "
                "(%d %% %d != 0)" % (what, int(n), self.n_devices))

    def bounds(self, n, shard):
        """[start, stop) of ``shard``'s equal share of ``n`` rows."""
        self.check_divides(n, "the sample axis")
        size = int(n) // self.n_devices
        return shard * size, (shard + 1) * size

    def shard_batch(self, array):
        """This process's equal slices of the leading axis of ``array``,
        one per local device and placed there.

        :return: list of tensors, in local shard order
        """
        x = torch.as_tensor(array)
        out = []
        for shard, device in self.local_shards():
            lo, hi = self.bounds(x.shape[0], shard)
            out.append(x[lo:hi].to(device))
        return out

    def synchronize(self):
        """Wait for every CUDA device of the mesh."""
        for device in set(self.devices):
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def reduce(self, per_shard):
        """Sum per-shard results over the mesh.

        :param per_shard: one result per local shard, in shard order: a
            tensor or a (nested) tuple/list/NamedTuple of tensors, the same
            structure on every shard
        :return: the structure with every leaf summed on ``devices[0]`` in
            shard order (floating leaves in f64, integer leaves in int64,
            then back to the leaf's dtype) and all-reduced over the group
        """
        if len(per_shard) != self.n_local:
            raise ValueError("%d results for %d local shards"
                             % (len(per_shard), self.n_local))
        with profiling.span("mesh.reduce"):
            return self._reduce(per_shard)

    def _reduce(self, per_shard):
        flat = [_flatten(r) for r in per_shard]
        rebuild = flat[0][1]
        leaves0 = flat[0][0]
        home = self.devices[0]
        sums = []
        for j, leaf in enumerate(leaves0):
            wide = torch.float64 if leaf.is_floating_point() else torch.int64
            acc = leaf.to(home, wide)
            for leaves, _ in flat[1:]:
                acc = acc + leaves[j].to(home, wide)
            sums.append(acc)
        if self.group is not None:
            for wide in (torch.float64, torch.int64):
                idx = [j for j, s in enumerate(sums) if s.dtype == wide]
                if not idx:
                    continue
                buf = torch.cat([sums[j].reshape(-1) for j in idx])
                with profiling.span("mesh.allreduce"):
                    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
                profiling.count("mesh.collectives")
                profiling.count("mesh.reduce_bytes", buf.numel() * buf.element_size())
                pos = 0
                for j in idx:
                    n = sums[j].numel()
                    sums[j] = buf[pos:pos + n].reshape(sums[j].shape)
                    pos += n
        return rebuild([s.to(leaf.dtype) for s, leaf in zip(sums, leaves0)])

    def gather(self, per_shard, device=None):
        """Concatenate per-shard rows over the mesh, in shard order.

        :param per_shard: one tensor per local shard; every shard of the
            mesh holds the same number of rows
        :param device: where the result goes (default ``devices[0]``)
        :return: tensor [n_devices * rows, ...]
        """
        if len(per_shard) != self.n_local:
            raise ValueError("%d results for %d local shards"
                             % (len(per_shard), self.n_local))
        home = self.devices[0]
        local = torch.cat([t.to(home) for t in per_shard])
        if self.group is not None:
            is_bool = local.dtype == torch.bool
            send = local.to(torch.uint8) if is_bool else local.contiguous()
            parts = [torch.empty_like(send) for _ in range(self.world_size)]
            with profiling.span("mesh.allgather"):
                dist.all_gather(parts, send, group=self.group)
            profiling.count("mesh.collectives")
            local = torch.cat(parts)
            if is_bool:
                local = local.to(torch.bool)
        return local if device is None else local.to(device)


def single_device_mesh(device=None) -> SampleMesh:
    """One shard on ``device`` (None: the current CUDA device), this
    process alone: what a driver runs on without a mesh."""
    return SampleMesh([resolve_device(device)], group=False)


def chunk_indices(mesh, shard, chunk, c, device):
    """Sample indices [chunk / D] of shard ``shard``'s part of chunk
    ``c``: ``c * chunk + shard * (chunk / D) + arange`` (JAX's offset by
    device position), int64 on ``device``."""
    sub = chunk // mesh.n_devices
    return (c * chunk + shard * sub
            + torch.arange(sub, dtype=torch.int64, device=device))


def chunk_rows(mesh, chunk, c, fn):
    """Per-sample rows of chunk ``c`` as one device computes them: ``fn``
    maps a shard's sample indices (``chunk_indices``) to a tensor or a
    tuple of tensors of rows, each shard's part runs on its device, and
    the parts are concatenated over the mesh in index order on
    ``devices[0]``. A driver that sums these rows adds them in the same
    order for any shard count, so its sums equal one device's bit for bit.

    :return: a tensor [chunk, ...] or a tuple of them
    """
    parts = [fn(chunk_indices(mesh, shard, chunk, c, device))
             for shard, device in mesh.local_shards()]
    if isinstance(parts[0], torch.Tensor):
        return mesh.gather(parts)
    return tuple(mesh.gather([p[j] for p in parts]) for j in range(len(parts[0])))


def sample_mesh(n_devices: Optional[int] = None) -> SampleMesh:
    """Mesh over the first ``n_devices`` CUDA devices (None = all)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is None:
        return SampleMesh()
    if count < n_devices:
        raise ValueError("requested {} devices, only {} available".format(
            n_devices, count))
    return SampleMesh([torch.device("cuda", i) for i in range(n_devices)])
