"""T2 negative fixture: host values, shapes, and the one sanctioned sync."""
import torch


class CollectHook:
    def __init__(self):
        self.losses = []

    def on_step_end(self, ctx, ev):
        self.losses.append(ev.loss)                 # host scalar already
        print(f"step {ev.step}: {len(self.losses)}")


def make_train_step(model, lr: float):
    def train_step(params, batch):
        n = int(batch["x"].shape[0])                # a shape: host
        rows = batch["x"].size(0) * batch["x"].numel()
        scale = float(lr) * n                       # a Python float
        loss = torch.sum(params["w"] * batch["x"]) * scale / rows
        return loss, {"loss": loss}                 # stays on the device
    return train_step


def setup(params):
    # not hot: runs once, before the loop
    return {k: v.cpu().numpy() for k, v in params.items()}


class ToyEngine:
    def _run_chunk(self):
        # ONE transfer per chunk boundary
        # repro-lint: disable=T2 — this IS the sanctioned single sync.
        host = torch.cat([self._tok, self._n]).cpu().numpy()
        return host.tolist()                        # host memory already
