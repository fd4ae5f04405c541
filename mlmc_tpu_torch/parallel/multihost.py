"""Several processes, one sample mesh (counterpart of
``mlmc_tpu/parallel/multihost.py``).

A run over several processes (one per host, or one per GPU) joins a
``torch.distributed`` process group; every process draws its shards of
each level on its own devices, and the per-level accumulators ([R],
[R, R], counts) are all-reduced over the group. The file storage is only a
checkpoint, never the transport.

On each process::

    from mlmc_tpu_torch.parallel import multihost, sharded_mlmc_step
    multihost.initialize("tcp://host0:29500", num_processes=2,
                         process_id=rank)          # no-op for one process
    mesh = multihost.global_sample_mesh()
    step = sharded_mlmc_step(mesh, fns, moments_fn, n_per_level)
    accs = step(seed)                  # the same on every process
    if multihost.is_coordinator():
        storage.save(...)              # host IO on process 0 only

The backend follows the devices: NCCL for CUDA devices, gloo for the CPU
(``devices=["cpu"]``); it is never swapped for the other. Where
``torchrun`` starts a process per card (``LOCAL_WORLD_SIZE`` > 1), a
process's devices default to its own card, ``LOCAL_RANK``.
"""
import os

import torch
import torch.distributed as dist

from mlmc_tpu_torch.parallel.mesh import SampleMesh, backend_for


def _local_devices(devices):
    """``devices`` as given; None means the card ``LOCAL_RANK`` names where
    ``torchrun`` started more than one process on this host
    (``LOCAL_WORLD_SIZE`` > 1) and it names a visible card, else every
    visible card (one process per host)."""
    if devices is not None:
        return list(devices)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false (pass devices=['cpu'] to run on the host)")
    count = torch.cuda.device_count()
    local_rank = os.environ.get("LOCAL_RANK", "")
    per_host = os.environ.get("LOCAL_WORLD_SIZE", "")
    if (per_host.isdigit() and int(per_host) > 1
            and local_rank.isdigit() and int(local_rank) < count):
        return [torch.device("cuda", int(local_rank))]
    return [torch.device("cuda", i) for i in range(count)]


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               devices=None):
    """Join the process group; a no-op for one process, and when the group
    is already initialised.

    :param coordinator_address: ``host:port`` of process 0 (or an
        ``init_method`` URL: ``tcp://...``, ``file://...``); None reads
        ``MASTER_ADDR``/``MASTER_PORT`` from the environment
    :param num_processes: world size; None reads ``WORLD_SIZE``
    :param process_id: this process's rank; None reads ``RANK``
    :param devices: this process's devices, which choose the backend;
        None means this process's card where ``torchrun`` started a
        process per card (``LOCAL_RANK``), else every visible CUDA device
        (NCCL)
    """
    if num_processes is not None and int(num_processes) <= 1:
        return
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None:
        if "WORLD_SIZE" not in env:
            # nothing names a cluster: a single-process run
            return
        num_processes = int(env["WORLD_SIZE"])
        if num_processes <= 1:
            return
    if process_id is None:
        if "RANK" not in env:
            raise ValueError("process_id is needed (or RANK in the environment)")
        process_id = int(env["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in str(coordinator_address):
        init_method = str(coordinator_address)
    else:
        init_method = "tcp://" + str(coordinator_address)
    local = [torch.device(d) for d in _local_devices(devices)]
    backend = backend_for(local)
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))


def is_coordinator() -> bool:
    """True on the process that owns storage and scheduling (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def n_hosts() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_sample_mesh(devices=None) -> SampleMesh:
    """The ``samples`` mesh over this process's devices and every process
    of the world group.

    :param devices: this process's devices; None = this process's card
        where ``torchrun`` started a process per card (``LOCAL_RANK``),
        else every visible CUDA device
    """
    return SampleMesh(_local_devices(devices))


def local_sample_mesh(devices=None) -> SampleMesh:
    """A mesh over this process's devices only (no reduction across
    processes)."""
    return SampleMesh(_local_devices(devices), group=False)
