"""Recurrent layers: LSTM and the vanilla RNN (counterpart of
``ops/recurrent.py``).

The reference unrolls an inner net through time (recurrent_layer.cpp);
the JAX package scans one step function.  Here the step runs in a Python
loop over time and autograd records it.

* LSTM step (lstm_layer.cpp): gates from one fused (4H) linear of
  [x_t, h_{t-1}], gate order i, f, o, g; c_t = f*c + i*g;
  h_t = o*tanh(c_t).
* RNN step (rnn_layer.cpp): h_t = tanh(W_x x_t + W_h h_{t-1} + b),
  output o_t = tanh(W_o h_t + b_o).
* ``cont`` (T, N): 0 resets the carried state before the step.
"""

from __future__ import annotations

import torch

from ..utils import fillers


def lstm_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
              *, device=None):
    """{'wx': (D, 4H), 'wh': (H, 4H), 'b': (4H,)}; gate order i, f, o, g."""
    return {
        "wx": fillers.xavier(generator, (input_dim, 4 * hidden_dim),
                             fan_in=input_dim, device=device),
        "wh": fillers.xavier(generator, (hidden_dim, 4 * hidden_dim),
                             fan_in=hidden_dim, device=device),
        "b": torch.zeros((4 * hidden_dim,), device=device),
    }


def _ones_cont(x):
    return torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)


def lstm_apply(params, x, *, cont=None, h0=None, c0=None):
    """x: (T, N, D) time-major -> (outputs (T, N, H), (h_T, c_T))."""
    t_len, n, _ = x.shape
    h_dim = params["wh"].shape[0]
    h = x.new_zeros((n, h_dim)) if h0 is None else h0
    c = x.new_zeros((n, h_dim)) if c0 is None else c0
    cont = _ones_cont(x) if cont is None else cont.to(x.dtype)
    outs = []
    for t in range(t_len):
        h = h * cont[t][:, None]
        c = c * cont[t][:, None]
        gates = x[t] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, o, g = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs), (h, c)


def rnn_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
             *, device=None):
    """{'wx': (D, H), 'b': (H,), 'wh': (H, H), 'wo': (H, H), 'bo': (H,)},
    the reference RNN's five blobs W_xh, b_h, W_hh, W_ho, b_o."""
    return {
        "wx": fillers.xavier(generator, (input_dim, hidden_dim),
                             fan_in=input_dim, device=device),
        "wh": fillers.xavier(generator, (hidden_dim, hidden_dim),
                             fan_in=hidden_dim, device=device),
        "b": torch.zeros((hidden_dim,), device=device),
        "wo": fillers.xavier(generator, (hidden_dim, hidden_dim),
                             fan_in=hidden_dim, device=device),
        "bo": torch.zeros((hidden_dim,), device=device),
    }


def rnn_apply(params, x, *, cont=None, h0=None):
    """x: (T, N, D) -> (outputs o_t (T, N, H), h_T); the top is the
    projected o_t, not the hidden state."""
    t_len, n, _ = x.shape
    h = x.new_zeros((n, params["wh"].shape[0])) if h0 is None else h0
    cont = _ones_cont(x) if cont is None else cont.to(x.dtype)
    outs = []
    for t in range(t_len):
        h = h * cont[t][:, None]
        h = torch.tanh(x[t] @ params["wx"] + h @ params["wh"] + params["b"])
        outs.append(torch.tanh(h @ params["wo"] + params["bo"]))
    return torch.stack(outs), h
