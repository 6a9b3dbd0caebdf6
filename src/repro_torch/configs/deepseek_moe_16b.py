"""deepseek-moe-16b [moe] — fine-grained experts, 2 shared + 64 routed
top-6 (arXiv:2401.06066)."""
import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "deepseek-moe-16b"
FAMILY = "transformer"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=102400, norm="rmsnorm", act="silu", glu=True,
        moe=MoEConfig(n_routed=64, top_k=6, d_ff_expert=1408, n_shared=2))


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab=128, dtype=torch.float32,
        moe=MoEConfig(n_routed=8, top_k=2, d_ff_expert=32, n_shared=1))
