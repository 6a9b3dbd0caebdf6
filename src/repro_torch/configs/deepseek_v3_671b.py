"""deepseek-v3-671b [moe] — MLA attention, 1 shared + 256 routed top-8,
sigmoid router, MTP head (arXiv:2412.19437).

Deviation (DESIGN.md): the real model's first 3 layers are dense; here all
61 layers are MoE so the layer stack stays homogeneous for the fused scan.
"""
import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig, MLAConfig

ARCH_ID = "deepseek-v3-671b"
FAMILY = "transformer"


def config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, d_ff=2048, vocab=129280, norm="rmsnorm", act="silu",
        glu=True, mtp=True,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, d_nope=128,
                      d_rope=64, d_v=128),
        moe=MoEConfig(n_routed=256, top_k=8, d_ff_expert=2048, n_shared=1,
                      router_score="sigmoid"))


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab=128, dtype=torch.float32, mtp=True,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, d_nope=16, d_rope=8,
                      d_v=16),
        moe=MoEConfig(n_routed=8, top_k=2, d_ff_expert=32, n_shared=1,
                      router_score="sigmoid"))
