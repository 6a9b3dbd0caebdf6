"""T5 positive fixture: the global RNG in hot paths."""
import random

import numpy as np
import torch


def make_train_step(model):
    def train_step(params, batch):
        noise = torch.randn(batch.shape)            # T5: default generator
        drop = torch.rand_like(batch) > 0.1         # T5: default generator
        params.normal_(0.0, 0.01)                   # T5: in-place, global
        jitter = np.random.normal(size=3)           # T5: numpy's global
        k = random.randint(0, 3)                    # T5: random's global
        return params + noise * drop, jitter, k
    return train_step


class ReseedHook:
    def on_step_end(self, ctx, ev):
        torch.manual_seed(ev.step)                  # T5: reseeds globally


class ToyEngine:
    def step(self):
        return torch.multinomial(self.probs, 1)     # T5: default generator
