"""mamba2-1.3b [ssm] — SSD state-space duality (arXiv:2405.21060)."""
import torch

from repro_torch.models.mamba2 import Mamba2Config

ARCH_ID = "mamba2-1.3b"
FAMILY = "mamba2"


def config() -> Mamba2Config:
    return Mamba2Config(
        name=ARCH_ID, n_layers=48, d_model=2048, vocab=50280, d_state=128,
        d_conv=4, expand=2, headdim=64, n_groups=1, chunk=128)


def smoke_config() -> Mamba2Config:
    return Mamba2Config(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, vocab=128,
        d_state=16, d_conv=4, expand=2, headdim=16, chunk=8,
        dtype=torch.float32)
