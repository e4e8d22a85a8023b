"""Device selection shared by the port's entry points."""
import torch

from . import place as _place


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one the caller names, else
    ``place.set_device``'s choice, else ``cuda``. Asking for CUDA
    (explicitly or by default) on a host without a GPU raises — the port
    never drops to the CPU unasked."""
    if device is None:
        device = _place.current_place()
    dev = torch.device("cuda") if device is None \
        else _place.to_torch_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
