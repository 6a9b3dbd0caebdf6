"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block with
per-application LoRA (arXiv:2411.15242)."""
import torch

from repro_torch.models.hybrid import HybridConfig

ARCH_ID = "zamba2-1.2b"
FAMILY = "hybrid"


def config() -> HybridConfig:
    return HybridConfig(
        name=ARCH_ID, n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, d_state=64, headdim=64, attn_every=6,
        lora_rank=128)


def smoke_config() -> HybridConfig:
    return HybridConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128, d_state=16, headdim=16,
        attn_every=2, lora_rank=8, chunk=8, dtype=torch.float32)
