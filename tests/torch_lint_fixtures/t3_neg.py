"""T3 negative fixture: saved tensors only read; new tensors written."""
import torch


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        y = x * w
        y.mul_(2.0)                                 # y is not saved
        ctx.save_for_backward(x, w)
        ctx.group = None
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gy * w
        gx.mul_(2.0)                                # a new tensor
        x = x * 1.0                                 # rebound: a new tensor
        x.add_(1.0)
        return gx, gy * x


def not_a_function(x):
    x.add_(1.0)                                     # no autograd.Function
    return x
