"""stablelm-12b [dense] — stablelm-2 family (hf:stabilityai/stablelm-2-1_6b):
LayerNorm + partial rotary (25%)."""
import torch

from repro_torch.models.transformer import LMConfig

ARCH_ID = "stablelm-12b"
FAMILY = "transformer"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab=100352, norm="layernorm", rope_pct=0.25,
        act="silu", glu=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, norm="layernorm", rope_pct=0.25,
        dtype=torch.float32)
