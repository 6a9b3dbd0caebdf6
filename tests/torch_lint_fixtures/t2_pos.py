"""T2 positive fixture: host reads of tensors in hot paths."""
import numpy as np
import torch
from torch import cuda as tc


class CollectHook:
    def __init__(self):
        self.losses = []

    def on_step_end(self, ctx, ev):
        self.losses.append(float(ev.loss))          # T2: coercion in hook
        self.losses.append(ev.metrics["acc"].item())  # T2: read in hook


def make_train_step(model):
    def train_step(params, batch):
        loss = torch.sum(params["w"] * batch["x"])
        if float(loss) > 1e3:                       # T2: float() of a tensor
            loss = loss * 0.5
        tc.synchronize()                            # T2: aliased sync
        return loss, {"loss": loss.item()}          # T2: .item()
    return train_step


def build_step_program(spec):
    def one_step(params, batch):
        g = params * batch
        norms = g.norm(dim=-1).tolist()             # T2: .tolist()
        return g, norms
    return one_step


class ToyEngine:
    def _run_chunk(self):
        return torch.cat([self._tok, self._n]).cpu()  # T2: per-chunk read

    def _collect(self):
        return np.asarray(self._out.numpy())        # T2: .numpy()
