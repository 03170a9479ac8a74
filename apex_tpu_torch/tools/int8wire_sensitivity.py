"""int8-wire gradient-sync sensitivity sweep.

Counterpart of ``tools/int8wire_sensitivity.py``.
:func:`~apex_tpu_torch.parallel.quantized_all_reduce_gradients` trades
exactness for ~4x fewer wire bytes.  This sweep maps its envelope: block
size x model scale ->

- one-sync relative gradient error vs the exact all-reduce (mean + max
  over elements, worst leaf), and
- the N-step training-loss delta vs exact sync from the same init
  (momentum SGD, :func:`~apex_tpu_torch.optimizers.fused_sgd`),

at data parallelism 8: eight worker processes joined over gloo
(:mod:`apex_tpu_torch.tools._ranks`), on the card (each rank's tensors
on card 0) unless ``--device cpu``.  The model is a tanh MLP regression
net; its inputs, targets and initial weights are drawn by numpy
(``RandomState(7)``) — the reference draws them with ``jax.random``,
whose threefry stream numpy does not reproduce, so :func:`measure` takes
them as arguments and can be fed the reference's arrays.

The table goes to stdout as the reference prints it, and its rows (JSON
lines) to ``build/INT8WIRE_SENSITIVITY_torch.json`` at the repository
root, so that the reference's committed ``INT8WIRE_SENSITIVITY.json``
stays the reference's.

Run::

    python -m apex_tpu_torch.tools.int8wire_sensitivity
    python -m apex_tpu_torch.tools.int8wire_sensitivity --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

DP = 8
N_STEPS = 30
D_IN = 16
ROWS = 64

# model scales: (hidden, depth, lr) of a tanh MLP regression net.
# "small" has mixed tiny/large leaves in one bucket; "large" spans many
# blocks per leaf, so per-block scaling is exercised within and across
# leaves.  lr is tuned per scale so the EXACT baseline converges.
SCALES = {
    "small (9.5k params)": (48, 2, 0.05),
    "medium (54k params)": (128, 3, 0.05),
    "large (528k params)": (512, 2, 0.005),
}
BLOCKS = (256, 1024, 4096)

#: the sweep's rows, as JSON lines
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "INT8WIRE_SENSITIVITY_torch.json")


def draw_inputs(hidden, depth, seed=7):
    """``(xs (DP, ROWS, D_IN), ys (DP, ROWS, 1), params)``: the sweep's
    data and initial weights from numpy — ``params`` a list of
    ``{"w": (a, b), "b": (b,)}`` f32 layers, w ~ N(0, 1/a), b = 0."""
    rs = np.random.RandomState(seed)
    xs = rs.randn(DP, ROWS, D_IN).astype(np.float32)
    w_true = rs.randn(D_IN, 1).astype(np.float32)
    ys = (np.einsum("rbd,do->rbo", xs, w_true)
          + 0.01 * rs.randn(DP, ROWS, 1)).astype(np.float32)
    dims = [D_IN] + [hidden] * depth + [1]
    params = [{"w": (rs.randn(a, b) / np.sqrt(a)).astype(np.float32),
               "b": np.zeros((b,), np.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    return xs, ys, params


def _flat(params_np, device):
    """The layers as one flat dict of tensors, in the reference tree's
    leaf order (layer by layer, "b" before "w"), so the int8 wire's
    bucket holds the same elements in the same blocks."""
    import torch

    return {f"{i}/{k}": torch.from_numpy(np.asarray(layer[k])).to(device)
            for i, layer in enumerate(params_np) for k in ("b", "w")}


def _mlp_apply(params, x, depth_plus_one):
    import torch

    for i in range(depth_plus_one):
        x = x @ params[f"{i}/w"] + params[f"{i}/b"]
        if i < depth_plus_one - 1:
            x = torch.tanh(x)
    return x


def _rank_measure(rank, world, *, xs, ys, params, lr, block, device):
    """One rank of :func:`measure`: the one-sync errors on its own rows,
    then N_STEPS of exact and of int8 sync from the same init; returns
    ``(mean_rel, max_rel, exact_hist, quant_hist)`` (the histories this
    rank's losses)."""
    import torch

    from apex_tpu_torch import parallel_state as ps
    from apex_tpu_torch.optimizers import fused_sgd
    from apex_tpu_torch.parallel import (
        all_reduce_gradients,
        quantized_all_reduce_gradients,
    )

    ps.initialize_model_parallel(1, 1)
    try:
        n = len(params)
        x = torch.from_numpy(xs[rank]).to(device)
        y = torch.from_numpy(ys[rank]).to(device)

        def loss_and_grads(p):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            loss = torch.mean((_mlp_apply(leaves, x, n) - y) ** 2)
            g = torch.autograd.grad(loss, list(leaves.values()))
            return loss.detach(), dict(zip(leaves, g))

        p0 = _flat(params, device)
        _, grads = loss_and_grads(p0)
        exact = all_reduce_gradients({k: g.clone() for k, g in grads.items()})
        quant = quantized_all_reduce_gradients(
            {k: g.clone() for k, g in grads.items()}, min_size=1,
            block=block)
        means, maxes = [], []
        for k in grads:
            e, q = exact[k], quant[k]
            denom = torch.mean(torch.abs(e)) + 1e-12
            means.append(float(torch.mean(torch.abs(q - e)) / denom))
            maxes.append(float(torch.max(torch.abs(q - e)) / denom))

        def train_hist(sync):
            tx = fused_sgd(learning_rate=lr, momentum=0.9)
            p = _flat(params, device)
            opt = tx.init(p)
            hist = []
            for _ in range(N_STEPS):
                loss, g = loss_and_grads(p)
                g = sync(g)
                upd, opt = tx.update(g, opt, p)
                p = {k: v + upd[k] for k, v in p.items()}
                hist.append(float(loss))
            return hist

        h_exact = train_hist(all_reduce_gradients)
        h_quant = train_hist(lambda g: quantized_all_reduce_gradients(
            g, min_size=1, block=block))
        return max(means), max(maxes), h_exact, h_quant
    finally:
        ps.destroy_model_parallel()


def measure(hidden, depth, lr, block, inputs=None, device="cuda"):
    """(worst-leaf mean rel err, worst-leaf max rel err, exact final
    loss, int8 final loss, loss delta as a fraction of the initial
    loss), at dp = DP.  ``inputs`` is ``(xs, ys, params)`` as
    :func:`draw_inputs` returns them (its draw by default)."""
    from apex_tpu_torch.ops._dispatch import resolve_device
    from apex_tpu_torch.tools._ranks import run_ranks

    device = resolve_device(device).type
    xs, ys, params = inputs if inputs is not None else draw_inputs(
        hidden, depth)
    params = [{k: np.asarray(v, np.float32) for k, v in layer.items()}
              for layer in params]
    out = run_ranks(DP, _rank_measure, dict(
        xs=np.asarray(xs, np.float32), ys=np.asarray(ys, np.float32),
        params=params, lr=lr, block=block, device=device), device=device)
    mean_rel, max_rel = out[0][0], out[0][1]
    # the mean over the ranks of each step's loss (the reference's pmean)
    h_exact = np.mean([o[2] for o in out], axis=0, dtype=np.float64)
    h_quant = np.mean([o[3] for o in out], axis=0, dtype=np.float64)
    loss_delta = float(h_quant[-1] - h_exact[-1]) / float(h_exact[0])
    return (float(mean_rel), float(max_rel), float(h_exact[-1]),
            float(h_quant[-1]), loss_delta)


def header() -> str:
    return (f"{'model':<22}{'block':>7}{'rel_err_mean':>14}{'rel_err_max':>13}"
            f"{'exact_loss':>12}{'quant_loss':>12}{'loss_delta':>12}")


def row_line(name, block, m, mx, le, lq, dl) -> str:
    return (f"{name:<22}{block:>7}{m:>14.5f}{mx:>13.5f}"
            f"{le:>12.6f}{lq:>12.6f}{dl:>12.6f}")


def sweep(scales=None, blocks=BLOCKS, device="cuda"):
    """Print the table over ``scales`` (names of :data:`SCALES`, all by
    default) x ``blocks``; returns its rows."""
    print(header(), flush=True)
    rows = []
    for name in scales or SCALES:
        hidden, depth, lr = SCALES[name]
        for block in blocks:
            m, mx, le, lq, dl = measure(hidden, depth, lr, block,
                                        device=device)
            rows.append({
                "model": name, "block": block,
                "rel_err_mean_worst_leaf": round(m, 5),
                "rel_err_max_worst_leaf": round(mx, 5),
                "exact_final_loss": round(le, 6),
                "quant_final_loss": round(lq, 6),
                "loss_delta_frac_of_init": round(dl, 6),
            })
            print(row_line(name, block, m, mx, le, lq, dl), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    rows = sweep(device=args.device)
    os.makedirs(os.path.dirname(DEFAULT_OUT), exist_ok=True)
    with open(DEFAULT_OUT, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    print(f"[int8wire_sensitivity] wrote {DEFAULT_OUT}", file=sys.stderr)


if __name__ == "__main__":
    main()
