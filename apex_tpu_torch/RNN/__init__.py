"""Recurrent networks — counterpart of :mod:`apex_tpu.RNN` (≙
``apex/RNN/`` :: ``RNNTanh``, ``RNNReLU``, ``LSTM``, ``GRU``,
``mLSTM``).

Time-first layout ``(T, B, H)``.  Each layer hoists its input-side GEMMs
out of the time loop (one ``(T·B, in)`` product for all steps, and
mLSTM's second input product beside it), then walks the steps in a plain
Python loop of PyTorch ops: the recurrent GEMM and the cell's gate math.
The reference has no kernel here (its loop is a ``lax.scan``), and
neither has the port.  Every GEMM accumulates in f32 and casts back to
the module's dtype (:func:`_dense`, the reference's ``_dense``), so the
carry is cast after each product.  Gate orders are torch's: i, f, g, o
for the LSTMs and r, z, n for the GRU, whose recurrent product has no
bias.  ``forward(x, initial_state=None)`` returns ``(outputs,
final_state)`` with each layer's final state stacked on a new first
axis (an ``(h, c)`` pair of them for the LSTMs).

Parameters per layer ``l`` keep the reference's names in PyTorch's
``(out, in)`` layout: ``w_ih_l`` ``(gates·H, in)``, ``w_hh_l``
``(gates·H, H)``, ``b_ih_l``, and mLSTM's ``w_mx_l`` ``(H, in)`` and
``w_mh_l`` ``(H, H)``; :func:`from_jax_params` transposes a JAX module's
``(in, out)`` kernels into them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.mlp import lecun_normal_, linear_f32_accumulate
from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = ["RNNReLU", "RNNTanh", "LSTM", "GRU", "mLSTM", "from_jax_params"]


def _dense(x, w, b=None):
    """``x @ w.T + b`` with f32 accumulation, in ``x``'s dtype."""
    from apex_tpu_torch.amp.lists import amp_cast

    x, w, b = amp_cast("rnn_gemm", x, w, b)
    return linear_f32_accumulate(x, w, b)


class _RNNBase(nn.Module):
    """The shared layer loop.  Subclasses set ``n_gates`` and define
    ``_cell(carry, inputs_t, layer)``, ``_init_carry(batch, like)`` and
    ``_carry_output(carry)``; ``_step_inputs`` gives the hoisted
    per-step inputs of a layer."""

    n_gates = 1
    pair_carry = False

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.bias = num_layers, bias
        g = self.n_gates * hidden_size
        for layer in range(num_layers):
            din = input_size if layer == 0 else hidden_size
            self._param(f"w_ih_{layer}", (g, din), dtype, dev, generator,
                        fan_in=din)
            self._param(f"w_hh_{layer}", (g, hidden_size), dtype, dev,
                        generator, orthogonal=True)
            self.register_parameter(
                f"b_ih_{layer}", nn.Parameter(torch.zeros(
                    g, dtype=dtype, device=dev)) if bias else None)
            self._layer_params(layer, din, dtype, dev, generator)

    def _param(self, name, shape, dtype, dev, generator, fan_in=None,
               orthogonal=False):
        w = nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))
        with torch.no_grad():
            if orthogonal:
                nn.init.orthogonal_(w, generator=generator)
            else:
                lecun_normal_(w, fan_in, generator)
        self.register_parameter(name, w)

    def _layer_params(self, layer, din, dtype, dev, generator):
        pass

    def _step_inputs(self, h, layer):
        return _dense(h, getattr(self, f"w_ih_{layer}"),
                      getattr(self, f"b_ih_{layer}"))

    def _init_carry(self, batch, like):
        z = like.new_zeros(batch, self.hidden_size)
        return (z, z) if self.pair_carry else z

    def _carry_output(self, carry):
        return carry[0] if self.pair_carry else carry

    def _cell(self, carry, inp, layer):
        raise NotImplementedError

    def forward(self, x, initial_state=None):
        """``x`` ``(T, B, input_size)`` -> ``(outputs (T, B, H),
        final_state)``."""
        dtype = self.w_ih_0.dtype
        h = x.to(dtype)
        finals = []
        for layer in range(self.num_layers):
            if initial_state is None:
                carry = self._init_carry(h.shape[1], h)
            elif self.pair_carry:
                carry = tuple(s[layer].to(dtype) for s in initial_state)
            else:
                carry = initial_state[layer].to(dtype)
            xs = self._step_inputs(h, layer)
            steps = xs[0].shape[0] if isinstance(xs, tuple) else xs.shape[0]
            outs = []
            for t in range(steps):
                inp = (tuple(a[t] for a in xs) if isinstance(xs, tuple)
                       else xs[t])
                carry = self._cell(carry, inp, layer)
                outs.append(self._carry_output(carry))
            finals.append(carry)
            h = torch.stack(outs)
        if self.pair_carry:
            final = tuple(torch.stack(parts) for parts in zip(*finals))
        else:
            final = torch.stack(finals)
        return h, final

    def extra_repr(self) -> str:
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}, bias={self.bias}")


class _Elman(_RNNBase):
    activation = staticmethod(torch.tanh)

    def _cell(self, h, gx, layer):
        return self.activation(gx + _dense(h, getattr(self, f"w_hh_{layer}")))


class RNNTanh(_Elman):
    """≙ ``apex.RNN.models.RNNTanh``."""

    activation = staticmethod(torch.tanh)


class RNNReLU(_Elman):
    """≙ ``apex.RNN.models.RNNReLU``."""

    activation = staticmethod(torch.relu)


def _lstm_update(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class LSTM(_RNNBase):
    """≙ ``apex.RNN.models.LSTM`` — gates (i, f, g, o), as torch's."""

    n_gates = 4
    pair_carry = True

    def _cell(self, carry, gx, layer):
        h, c = carry
        return _lstm_update(gx + _dense(h, getattr(self, f"w_hh_{layer}")),
                            c)


class GRU(_RNNBase):
    """≙ ``apex.RNN.models.GRU`` — gates (r, z, n), as torch's, with no
    bias on the recurrent product."""

    n_gates = 3

    def _cell(self, h, gx, layer):
        gh = _dense(h, getattr(self, f"w_hh_{layer}"))
        rx, zx, nx = gx.chunk(3, dim=-1)
        rh, zh, nh = gh.chunk(3, dim=-1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh)
        return (1.0 - z) * n + z * h


class mLSTM(_RNNBase):
    """The multiplicative LSTM — ≙ ``apex.RNN.cells`` ::
    ``mLSTMRNNCell``: ``m = (x·W_mx) ⊙ (h·W_mh)`` replaces ``h`` as the
    recurrent input of the four LSTM gates; both input-side products are
    hoisted out of the loop."""

    n_gates = 4
    pair_carry = True

    def _layer_params(self, layer, din, dtype, dev, generator):
        self._param(f"w_mx_{layer}", (self.hidden_size, din), dtype, dev,
                    generator, fan_in=din)
        self._param(f"w_mh_{layer}", (self.hidden_size, self.hidden_size),
                    dtype, dev, generator, orthogonal=True)

    def _step_inputs(self, h, layer):
        return (_dense(h, getattr(self, f"w_mx_{layer}")),
                super()._step_inputs(h, layer))

    def _cell(self, carry, inp, layer):
        h, c = carry
        mx_t, gx_t = inp
        m = mx_t * _dense(h, getattr(self, f"w_mh_{layer}"))
        return _lstm_update(gx_t + _dense(m, getattr(self, f"w_hh_{layer}")),
                            c)


@torch.no_grad()
def from_jax_params(module: nn.Module, params_np) -> nn.Module:
    """Copy a JAX RNN module's params (numpy; ``{"params": ...}`` or the
    params alone) into ``module`` by name, each ``(in, out)`` kernel
    transposed; returns it."""
    params = params_np.get("params", params_np)
    for key, value in params.items():
        value = torch.tensor(np.asarray(value))
        if key.startswith("w_"):
            value = value.t()
        getattr(module, key).copy_(value)
    return module
