"""T5 negative fixture: explicit generators only, and no RNG at all."""
import numpy as np
import torch


def make_train_step(model, seed: int):
    gen = torch.Generator().manual_seed(seed)

    def train_step(params, batch):
        noise = torch.randn(batch.shape, generator=gen)
        params.normal_(0.0, 0.01, generator=gen)
        rng = np.random.default_rng(seed)
        return params + noise, rng.normal(size=3)
    return train_step


def init_params(shape, seed):
    # not hot: runs once
    torch.manual_seed(seed)
    return torch.randn(shape)
