"""Where the entry points of the package run.

Every public entry point runs on the current CUDA device unless the caller
names another device. ``device="cpu"`` runs the plain PyTorch versions on
the host (as the tests do); a CUDA device that is not there raises instead
of falling back to the CPU.
"""
import torch


def cuda_device(device):
    """``device`` as an indexed CUDA device; raises if it is not one or
    CUDA is unavailable (a CUDA request never runs on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the CUDA kernels need a CUDA device, got %s" % device)
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but "
                           "torch.cuda.is_available() is false (pass "
                           "device='cpu' to run on the host)")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device=None, like=None):
    """The device an entry point runs on.

    :param device: the caller's choice; None means the current CUDA device
    :param like: an input of the call: a tensor (or generator) keeps its
        own device when ``device`` is None; anything else (numpy) goes to
        the card
    """
    if device is None and isinstance(like, (torch.Tensor, torch.Generator)):
        device = like.device
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        return cuda_device(device)
    if device.type != "cpu":
        raise ValueError("unsupported device %s" % device)
    return device
