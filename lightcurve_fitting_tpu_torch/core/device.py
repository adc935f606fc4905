"""Where an entry point runs: on the card unless the caller asks for the CPU.

A fit that was meant for the GPU must never carry on quietly through the
plain PyTorch versions on the CPU because CUDA is missing or broken, so the
default is CUDA and its absence is an error.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` as a :class:`torch.device`; ``None`` means CUDA, and raises
    RuntimeError when CUDA is not available (pass ``device="cpu"`` to run the
    plain PyTorch versions)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port's entry points run on the GPU by "
                           'default; pass device="cpu" to run the plain PyTorch versions')
    return torch.device("cuda")
