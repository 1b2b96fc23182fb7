"""Multi-dimensional (2-D) LSTM (PyTorch port of
``paddle_tpu/layers/mdlstm.py``; ref gserver/layers/MDLstmLayer.cpp: Graves'
MDLSTM over a grid, one forget gate per dimension).

Cell (i, j) sees h and c from (i - 1, j) and (i, j - 1):

    gates = x W + b + h_up U_u + h_left U_l      (5C: i, f_l, f_u, o, g)
    c     = f_l * c_left + f_u * c_up + i * tanh(g)
    h     = o * tanh(c)

The arithmetic keeps the reference's structure: one ``x @ W + b`` over the
whole grid; per row one batched ``h_up @ U_u`` over [N, W, C] (the row
above is complete); per column ``h_left @ U_l``, added as ``(xw_row + h_up
@ U_u) + h_left @ U_l``.  The reference sweeps with two nested
``lax.scan``s; here two Python loops, which autograd records and
``Executor.warm`` captures."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.program import Variable
from ..initializer import Xavier
from .helper import LayerHelper


def md_lstm(input: Variable, size: int, reverse_h: bool = False,
            reverse_w: bool = False, param_attr=None, bias_attr=None,
            name: Optional[str] = None):
    """2-D LSTM over ``input`` [N, H, W, D]; returns the hidden states [N,
    H, W, size].  ``reverse_h`` / ``reverse_w`` sweep the grid bottom-up /
    right to left (the grid is flipped before the sweep and the states
    after it)."""
    helper = LayerHelper("md_lstm", name=name)
    d_in = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [d_in, 5 * size], input.dtype,
                                default_initializer=Xavier())
    u_l = helper.create_parameter(param_attr, [size, 5 * size], input.dtype,
                                  default_initializer=Xavier())
    u_u = helper.create_parameter(param_attr, [size, 5 * size], input.dtype,
                                  default_initializer=Xavier())
    b = helper.create_parameter(bias_attr, [5 * size], input.dtype,
                                is_bias=True)

    def fn(ctx, x, wv, ulv, uuv, bv, size, reverse_h, reverse_w):
        if reverse_h:
            x = torch.flip(x, (1,))
        if reverse_w:
            x = torch.flip(x, (2,))
        n, hgt, wid, _ = x.shape
        xw = x @ wv + bv                      # [N, H, W, 5C]
        h_up = c_up = x.new_zeros((n, wid, size))
        zeros = x.new_zeros((n, size))
        rows = []
        for i in range(hgt):
            pre = xw[:, i] + h_up @ uuv       # [N, W, 5C]
            h, c = zeros, zeros
            hs, cs = [], []
            for j in range(wid):
                g = pre[:, j] + h @ ulv
                ig, fl, fu, og, cand = torch.split(g, size, dim=-1)
                c = (torch.sigmoid(fl) * c + torch.sigmoid(fu) * c_up[:, j]
                     + torch.sigmoid(ig) * torch.tanh(cand))
                h = torch.sigmoid(og) * torch.tanh(c)
                hs.append(h)
                cs.append(c)
            h_up, c_up = torch.stack(hs, 1), torch.stack(cs, 1)
            rows.append(h_up)
        out = torch.stack(rows, 1)            # [N, H, W, C]
        if reverse_h:
            out = torch.flip(out, (1,))
        if reverse_w:
            out = torch.flip(out, (2,))
        return out

    return helper.append_op(
        fn, {"X": [input], "W": [w], "Ul": [u_l], "Uu": [u_u], "B": [b]},
        attrs={"size": size, "reverse_h": reverse_h, "reverse_w": reverse_w},
                            axes=(1, 2))


__all__ = ["md_lstm"]
