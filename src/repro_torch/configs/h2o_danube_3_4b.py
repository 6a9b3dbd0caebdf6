"""h2o-danube-3-4b [dense, SWA] — llama+mistral mix (arXiv:2401.16818)."""
import torch

from repro_torch.models.transformer import LMConfig

ARCH_ID = "h2o-danube-3-4b"
FAMILY = "transformer"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_ff=10240, vocab=32000, window=4096, rope_theta=10000.0,
        norm="rmsnorm", act="silu", glu=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=96, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab=128, window=8, dtype=torch.float32)
