"""Convolutional GRU used to chain head groups, counterpart of
`centerpose_tpu/models/conv_gru.py`.

Parity target: `ConvGRUCell`/`ConvGRU` (convGRU.py:7-94). Cell equations (the
reference's br/bz/bin/bhn tensors are zero constants, never parameters, and
are omitted; Wi* convs carry bias, Wh* convs do not):

    r_t = sigmoid(Wir(x) + Whr(h))
    z_t = sigmoid(Wiz(x) + Whz(h))
    n_t = tanh(Win(x) + r_t * Whn(h))
    h_t = (1 - z_t) * n_t + z_t * h_{t-1}

The cell is iterated `steps` times on the SAME feature x, from h_0 = 0. The
six convolutions are kept as six per-gate `nn.Conv2d`; the three input
projections do not depend on the step and are computed once.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn


class ConvGRUCell(nn.Module):
    def __init__(self, cin: int, hidden: int = 64, kernel: int = 3):
        super().__init__()
        pad = kernel // 2
        self.hidden = hidden
        self.Wir = nn.Conv2d(cin, hidden, kernel, padding=pad)
        self.Wiz = nn.Conv2d(cin, hidden, kernel, padding=pad)
        self.Win = nn.Conv2d(cin, hidden, kernel, padding=pad)
        self.Whr = nn.Conv2d(hidden, hidden, kernel, padding=pad, bias=False)
        self.Whz = nn.Conv2d(hidden, hidden, kernel, padding=pad, bias=False)
        self.Whn = nn.Conv2d(hidden, hidden, kernel, padding=pad, bias=False)

    def input_proj(self, x):
        """(Wir(x), Wiz(x), Win(x)) — the same for every step."""
        return self.Wir(x), self.Wiz(x), self.Win(x)

    def forward(self, x, h, xp=None):
        xr, xz, xn = self.input_proj(x) if xp is None else xp
        r = torch.sigmoid(xr + self.Whr(h))
        z = torch.sigmoid(xz + self.Whz(h))
        n = torch.tanh(xn + r * self.Whn(h))
        return (1.0 - z) * n + z * h


class ConvGRU(nn.Module):
    """Fixed-step ConvGRU over a constant input feature. Returns the list of
    per-step hidden states, each [B, hidden, H, W]."""

    def __init__(self, cin: int, steps: int = 3, hidden: int = 64, kernel: int = 3):
        super().__init__()
        self.steps = steps
        self.hidden = hidden
        self.cell0 = ConvGRUCell(cin, hidden, kernel)

    def forward(self, x) -> List[torch.Tensor]:
        h = x.new_zeros((x.shape[0], self.hidden, x.shape[2], x.shape[3]))
        h = h.contiguous(memory_format=torch.channels_last)
        xp = self.cell0.input_proj(x)
        outputs = []
        for _ in range(self.steps):
            h = self.cell0(x, h, xp=xp)
            outputs.append(h)
        return outputs
