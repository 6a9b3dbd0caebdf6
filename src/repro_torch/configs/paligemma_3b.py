"""paligemma-3b [vlm] — SigLIP frontend STUBBED (the batch's
``prefix_embed`` carries the patch embeddings); gemma-2b decoder backbone
with prefix-LM masking (arXiv:2407.07726)."""
import torch

from repro_torch.models.transformer import LMConfig

ARCH_ID = "paligemma-3b"
FAMILY = "transformer"

N_PATCHES = 256  # 224px / 14 -> 16x16 SigLIP patches


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_head=256, d_ff=16384, vocab=257216, norm="rmsnorm", act="gelu",
        glu=True, tie_embeddings=True, embed_scale=True, prefix_lm=True,
        n_prefix_tokens=N_PATCHES)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_head=16, d_ff=128, vocab=128, act="gelu",
        tie_embeddings=True, embed_scale=True, prefix_lm=True,
        n_prefix_tokens=8, dtype=torch.float32)
