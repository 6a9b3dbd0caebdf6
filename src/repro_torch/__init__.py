"""PyTorch/CUDA port of the AdaLomo system, beside the JAX package ``repro``.

Same sub-package and module names as ``repro``: the counterpart of a module
is found by its path.  The port imports ``torch`` and never ``jax`` or
anything of ``repro``.  Its entry points run on a CUDA device unless the
caller asks for the CPU (``device="cpu"``; CLI ``--device cpu``).
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for (the default of every entry point) and the machine has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and this machine "
            "has none; pass device='cpu' (CLI: --device cpu) to run on the "
            "CPU")
    return dev
