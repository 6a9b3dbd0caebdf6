"""T4 positive fixture: launch-wrapper hygiene violations."""
import triton                                        # T4: at module level

from repro_torch.kernels import dry
from repro_torch.kernels.build import load_library

LIB = load_library("toy", ["toy.cu"])                # T4: built at import


def scale_ref(x):
    return x * 2.0


def scale_fallback(x):
    try:
        LIB.scale_launch(x.data_ptr(), x.numel())
    except RuntimeError:
        return scale_ref(x)                          # T4: hides the kernel
    return x


def scale_on_card(x):
    if x.is_cuda:
        return scale_ref(x)                          # T4: CUDA tensor
    LIB.scale_launch(x.data_ptr(), x.numel())
    return x


def scale_truncating(x, block=128):
    if dry.plain(x):
        return scale_ref(x)
    blocks = x.numel() // block
    LIB.scale_launch(x.data_ptr(), blocks)           # T4: floordiv extent
    return x


def scale_triton(kernel, x, block=128):
    if not x.is_cuda:
        return scale_ref(x)
    kernel[(x.numel() // block,)](x, block)          # T4: floordiv grid
    return x
