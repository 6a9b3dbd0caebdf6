"""h2o-danube-1.8b [dense, SWA] — llama+mistral mix (arXiv:2401.16818)."""
import torch

from repro_torch.models.transformer import LMConfig

ARCH_ID = "h2o-danube-1.8b"
FAMILY = "transformer"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=6912, vocab=32000, window=4096, rope_theta=10000.0,
        norm="rmsnorm", act="silu", glu=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, window=8, dtype=torch.float32)
