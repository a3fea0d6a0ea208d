"""ANN layers of the slice: the prediction layer.

Counterpart of event_flow_tpu/models/cells.py::ConvLayer (:106-124) as
FireNet uses it: the ``w_scale`` init (U(+-w_scale), zero bias) and tanh.
The conv is kernel K1 (ops/conv.py); the bias add and the tanh are plain
torch, as they sit outside the Pallas kernel in JAX.
"""

import torch
from torch import nn

from ..ops.conv import conv2d_same
from .snn_cells import ConvWeight

__all__ = ["ConvLayer"]


class ConvLayer(nn.Module):
    """Stride-1 conv + bias + tanh, stateless."""

    def __init__(self, cin, features, kernel_size, w_scale=0.01,
                 generator=None):
        super().__init__()
        self.conv2d = ConvWeight(cin, features, kernel_size, bias=True)
        with torch.no_grad():
            self.conv2d.weight.uniform_(-w_scale, w_scale,
                                        generator=generator)

    def forward(self, x):
        return torch.tanh(conv2d_same(x, self.conv2d.weight)
                          + self.conv2d.bias)
