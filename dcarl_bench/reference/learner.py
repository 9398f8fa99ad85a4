"""Plain reference of the learner's TD step: the ego-attention Q-network
(zhcao92/DCARL ``drl_library/dqn/dqn.py:24-54``), the prioritized TD
loss (``compute_td_loss``, dqn.py:176-213) and one Adam step.

Parameters are a dict of tensors named as the network's
``named_parameters()``: ``q_lin``, ``k_lin``, ``v_lin`` (token width 5
to attention width 3) and ``head.0``, ``head.2``, ``head.4`` (width 3
to 128 to 128 to the actions).  ``tf32=True`` rounds both operands of
every matrix product to TF32 and sums in float32: the control.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from dcarl_bench.reference.store import tf32 as _tf32


class _Tf32Matmul(torch.autograd.Function):
    """``a @ b`` as a TF32 tensor core computes it, forward and backward:
    each product's operands rounded to TF32, sums in float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        ga = g @ _tf32(b).transpose(-1, -2)
        gb = _tf32(a).transpose(-1, -2) @ g
        # a [B, n, k] against a shared b [k, m]: sum b's gradient over B
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return _Tf32Matmul.apply(a, b)
    return a @ b


def q_values(p: Dict[str, torch.Tensor], x: torch.Tensor, token_dim: int,
             tf32: bool = False) -> torch.Tensor:
    """[B, A] Q-values of flat observations ``x`` [B, n * token_dim]."""
    b = x.shape[0]
    t = x.reshape(b, -1, token_dim)

    def dense(name, h):
        return _mm(h, p[f"{name}.weight"].T, tf32) + p[f"{name}.bias"]

    q, k, v = dense("q_lin", t), dense("k_lin", t), dense("v_lin", t)
    scores = torch.softmax(_mm(q, k.transpose(1, 2), tf32)
                           / math.sqrt(x.shape[1]), dim=-1)
    ego = _mm(scores, v, tf32)[:, 0, :]
    h = torch.relu(dense("head.0", ego))
    h = torch.relu(dense("head.2", h))
    return dense("head.4", h)


def td_step(params, target, adam, batch, cfg: Dict, tf32: bool = False):
    """One TD step from the learner's state before it.

    ``params`` / ``target``: online and target weights; ``adam``: name ->
    (exp_avg, exp_avg_sq, step); ``batch``: dict of obs, action, reward,
    next_obs, done, weights.  Computed in float64 (float32 with
    ``tf32``).  Returns (loss, gradients, new weights), the last two
    dicts by name."""
    dt = torch.float32 if tf32 else torch.float64
    p = {k: v.detach().to(dt).clone().requires_grad_(True)
         for k, v in params.items()}
    tg = {k: v.detach().to(dt) for k, v in target.items()}
    obs, nxt = batch["obs"].to(dt), batch["next_obs"].to(dt)
    action = batch["action"].to(torch.int64)
    q_sa = q_values(p, obs, cfg["token_dim"], tf32).gather(
        1, action[:, None])[:, 0]
    with torch.no_grad():
        next_q = q_values(tg, nxt, cfg["token_dim"], tf32).max(dim=1).values
        y = batch["reward"].to(dt) + cfg["gamma"] * next_q \
            * (1.0 - batch["done"].to(dt))
    loss = ((q_sa - y) ** 2 * batch["weights"].to(dt)).mean()
    names = list(p)
    grads = dict(zip(names, torch.autograd.grad(loss, [p[k] for k in names])))
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, cfg["lr"]
    new = {}
    for k in names:
        m0, v0, step = adam[k]
        t = float(step) + 1.0
        g = grads[k].detach()
        m = b1 * m0.to(dt) + (1 - b1) * g
        v = b2 * v0.to(dt) + (1 - b2) * g * g
        upd = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
        new[k] = p[k].detach() - lr * upd
    return loss.detach(), {k: g.detach() for k, g in grads.items()}, new


def leaf_gaps(port: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              counted) -> Dict[str, float]:
    """Each counted leaf's gap between the norms of ``port`` and ``ref``,
    against the larger of that leaf's reference norm and the median
    leaf's."""
    norms = {k: float(ref[k].to(torch.float64).norm()) for k in ref}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(port[k].to(torch.float64).norm()) - norms[k])
            / max(norms[k], med, 1e-300) for k in counted}


def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def counted_leaves(ref_grads: Dict[str, torch.Tensor]):
    """Leaves whose reference gradient is not nought to rounding: norm at
    least a thousandth of the median leaf's (a key's bias under softmax
    has an exact gradient of 0, and Adam moves it by rounding alone)."""
    norms = {k: float(g.to(torch.float64).norm()) for k, g in
             ref_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * med]
