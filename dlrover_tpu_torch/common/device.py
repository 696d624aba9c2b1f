"""Device selection shared by the port's entry points."""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    no card is present. The port never falls back to the CPU on its
    own: a caller that wants the plain CPU path asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
