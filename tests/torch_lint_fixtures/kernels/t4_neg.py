"""T4 negative fixture: the wrappers' own idiom."""
from repro_torch.kernels import dry
from repro_torch.kernels.build import load_library


def scale_ref(x):
    return x * 2.0


def _library():
    return load_library("toy", ["toy.cu"])           # built at first use


def scale(x, block=128):
    if dry.plain(x):
        return scale_ref(x)                          # a CPU tensor only
    blocks = -(-x.numel() // block)                  # a ceiling
    err = _library().scale_launch(x.data_ptr(), blocks)
    if err != 0:
        raise RuntimeError(f"scale: CUDA error {err}")
    return x


def scale_exact(x, block=128):
    if x.device.type != "cuda":
        return scale_ref(x)
    if x.numel() % block:
        raise ValueError("numel must divide by the block")
    _library().scale_launch(x.data_ptr(), x.numel() // block)
    return x


def scale_triton(kernel, x, block=128):
    import triton                                    # inside the launcher
    if not x.is_cuda:
        return scale_ref(x)
    kernel[(triton.cdiv(x.numel(), block),)](x, block)
    return x
