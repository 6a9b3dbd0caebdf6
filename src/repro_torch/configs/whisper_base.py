"""whisper-base [audio] — enc-dec (arXiv:2212.04356); the conv frontend is
stubbed: a train batch carries precomputed frame embeddings ``frames [B,
n_frames, d_model]``."""
import torch

from repro_torch.models.encdec import EncDecConfig

ARCH_ID = "whisper-base"
FAMILY = "encdec"


def config() -> EncDecConfig:
    return EncDecConfig(
        name=ARCH_ID, n_enc_layers=6, n_dec_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865, n_frames=1500)


def smoke_config() -> EncDecConfig:
    return EncDecConfig(
        name=ARCH_ID + "-smoke", n_enc_layers=2, n_dec_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, n_frames=24,
        dtype=torch.float32)
