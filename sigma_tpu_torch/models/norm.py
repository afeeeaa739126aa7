"""BatchNorm of the port (counterpart of flax `nn.BatchNorm(momentum=0.9,
epsilon=1e-5)` as the JAX package's decoders use it), channel-last.

flax's arithmetic, not torch's:

  * batch statistics in fp32 whatever the input's dtype: the mean and
    E[x^2] over every axis but the last, var = max(E[x^2] - mean^2, 0)
    (`use_fast_variance`), so one value per channel (UPerHead's 1x1 pool
    at batch 1) gives var 0 instead of raising;
  * the running variance takes the biased batch variance:
    running = 0.9 * running + 0.1 * batch (torch.nn.BatchNorm2d takes the
    unbiased one, n / (n - 1) of it);
  * y = (x - mean) * (rsqrt(var + eps) * weight) + bias, promoted with
    the fp32 parameters: a bf16 input gives an fp32 output.

In a rank of data-parallel training (parallel/dist.py) the statistics are
the global batch's: each rank all-reduces its per-channel count, sum and
sum of squares in fp32 through an all-reduce that autograd differentiates,
so the gradients are those of the global batch's statistics, as JAX's
step over its sharded batch gives them (tests/test_syncbn.py). In eval
mode the running statistics normalise. The running statistics move once
per training forward, under no_grad; no module of the port that holds a
BatchNorm is rematerialized.
"""

from __future__ import annotations

import torch
from torch import nn

from sigma_tpu_torch.parallel.dist import all_reduce_sum_autograd


class BatchNorm(nn.Module):
    """flax BatchNorm over the last axis: parameters `weight` (ones) and
    `bias` (zeros), buffers `running_mean` (zeros) and `running_var`
    (ones)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def batch_stats(self, x):
        """(mean, biased var) of x over every axis but the last, in fp32,
        over the global batch in a data-parallel rank."""
        dims = tuple(range(x.ndim - 1))
        xf = x.float()
        count = torch.full_like(xf[(0,) * (x.ndim - 1)],
                                xf.numel() // xf.shape[-1])
        sums = all_reduce_sum_autograd(
            torch.stack([xf.sum(dims), (xf * xf).sum(dims), count]))
        mean, mean2 = sums[0] / sums[2], sums[1] / sums[2]
        return mean, torch.maximum(mean2 - mean * mean,
                                   torch.zeros_like(mean))

    def forward(self, x):
        if self.training:
            mean, var = self.batch_stats(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
