"""qwen3-32b [dense] — qk-norm + GQA (hf:Qwen/Qwen3-8B family).
Qwen3 uses an explicit head_dim=128 (q proj widens 5120 -> 8192)."""
import torch

from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen3-32b"
FAMILY = "transformer"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        d_head=128, d_ff=25600, vocab=151936, qk_norm=True,
        rope_theta=1_000_000.0, norm="rmsnorm", act="silu", glu=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=128, vocab=128, qk_norm=True,
        dtype=torch.float32)
