"""T3 positive fixture: in-place writes to tensors saved for backward."""
import torch


class ScaleThenClobber(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        y = x * w
        ctx.save_for_backward(x, w)
        x.mul_(2.0)                                 # T3: saved x written
        w[0] = 0.0                                  # T3: saved w written
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        w += 1.0                                    # T3: in backward
        return gy * w, gy * x


class KeptOnCtx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.x = x
        out = x.exp()
        torch.exp(x, out=x)                         # T3: out= a saved one
        return out

    @staticmethod
    def backward(ctx, g):
        x = ctx.x
        x.add_(1.0)                                 # T3: kept on ctx
        return g * x
