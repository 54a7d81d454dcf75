"""The solver family: SGD / Nesterov / AdaGrad / RMSProp / AdaDelta / Adam
(counterpart of ``training/optim.py``).

Parameters, gradients and solver history are nested dicts of tensors.
Every update is element-wise PyTorch under ``torch.no_grad()``; there is no
``torch.optim`` here, because the reference's rules differ from it (its
AdaDelta adds delta to both accumulators before the ratio).  ``apply``
returns new tensors and leaves its inputs untouched, so a caller may keep
references to earlier params without copying.

Semantics, in the reference's order (SGDSolver::ApplyUpdate,
sgd_solver.cpp:102-116):

  1. learning-rate policy          (GetLearningRate, sgd_solver.cpp:27-63)
  2. global L2 gradient clipping   (ClipGradients, sgd_solver.cpp:81-99) --
     over the *raw summed* gradient, before normalization; any value >= 0
     clips (0 freezes training)
  3. iter_size normalization       (Normalize, sgd_solver.cpp:119-142)
  4. L2/L1 weight decay folded into the gradient with per-param decay_mult
                                   (Regularize, sgd_solver.cpp:145-204)
  5. per-solver update rule with per-param lr_mult (ComputeUpdateValue)
  6. params -= update              (Net::Update / Blob::Update)

Update rules (diff == value subtracted from params):
  SGD      h = m*h + lr*g;                        diff = h
  Nesterov h' = m*h + lr*g;                       diff = (1+m)*h' - m*h
  AdaGrad  h += g^2;                              diff = lr * g/(sqrt(h)+eps)
  RMSProp  h = (1-rd)*g^2 + rd*h;                 diff = lr * g/(sqrt(h)+eps)
  AdaDelta h  = (1-m)*g^2 + m*h
           u  = g * sqrt((h2+eps)/(h+eps))
           h2 = (1-m)*u^2 + m*h2;                 diff = lr * u
  Adam     m_t = (1-b1)*g + b1*m; v_t = (1-b2)*g^2 + b2*v
           c = sqrt(1-b2^t)/(1-b1^t), t = step+1
           diff = lr*c * m_t/(sqrt(v_t)+eps)

The learning rate, Adam's correction and the clip scale are float32
tensors computed on the device, as the reference's in-graph forms are,
from a step that may itself be a 0-d device tensor, so a step makes no
host round trip.  The QA recipe: AdaDelta, base_lr=1.0, momentum=0.95,
delta=5e-7, weight_decay=5e-4, fixed LR, no clipping.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The SolverParameter subset that affects optimization
    (caffe.proto:102-242)."""
    solver_type: str = "adadelta"   # sgd|nesterov|adagrad|rmsprop|adadelta|adam
    base_lr: float = 1.0
    lr_policy: str = "fixed"        # fixed|step|exp|inv|multistep|poly|sigmoid
    gamma: float = 0.1
    power: float = 1.0
    stepsize: int = 1
    stepvalues: Sequence[int] = ()
    max_iter: int = 40001
    momentum: float = 0.95
    momentum2: float = 0.999        # adam beta2
    rms_decay: float = 0.99
    delta: float = 5e-7             # numerical guard (adadelta/adagrad/adam)
    weight_decay: float = 5e-4
    regularization_type: str = "L2"
    clip_gradients: float = -1.0    # < 0 disables (proto default)
    iter_size: int = 1


def learning_rate(cfg: SolverConfig, step, device=None) -> torch.Tensor:
    """LR policies (sgd_solver.cpp:27-63) as a 0-d float32 tensor.

    ``step``: a Python int, or a 0-d integer or float32 tensor on
    ``device``, which the rate is computed from on that device with no
    host round trip (a captured CUDA graph computes its steps so)."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    p = cfg.lr_policy
    if p == "fixed":
        return torch.full((), cfg.base_lr, dtype=torch.float32,
                          device=step.device)
    if p == "step":
        if cfg.stepsize <= 0:
            # the reference crashes on iter_ / stepsize; returning lr=0
            # (gamma**inf) would silently freeze training
            raise ValueError("lr_policy 'step' needs stepsize > 0")
        return cfg.base_lr * cfg.gamma ** torch.floor(step / cfg.stepsize)
    if p == "exp":
        return cfg.base_lr * cfg.gamma ** step
    if p == "inv":
        return cfg.base_lr * (1.0 + cfg.gamma * step) ** (-cfg.power)
    if p == "multistep":
        # the boundaries passed, counted against each as a Python number
        # (a tensor of them would be a host-to-device copy)
        current = torch.zeros((), dtype=torch.float32, device=step.device)
        for boundary in cfg.stepvalues:
            current = current + (step >= float(boundary)).to(torch.float32)
        return cfg.base_lr * cfg.gamma ** current
    if p == "poly":
        return cfg.base_lr * (1.0 - step / cfg.max_iter) ** cfg.power
    if p == "sigmoid":
        return cfg.base_lr / (1.0 + torch.exp(-cfg.gamma
                                              * (step - cfg.stepsize)))
    raise ValueError(f"unknown lr_policy {p}")


class Solver:
    """``make_solver`` product: ``init(params) -> opt_state``;
    ``apply(params, grads, opt_state, step) -> (new_params, new_opt_state)``.
    """

    def __init__(self, cfg: SolverConfig, spec=None):
        self.cfg = cfg
        self.spec = spec  # tree of (lr_mult, decay_mult), or None for (1, 1)

    def init(self, params):
        t = self.cfg.solver_type
        if t in ("sgd", "nesterov", "adagrad", "rmsprop"):
            return {"h": tree_map(torch.zeros_like, params)}
        if t in ("adadelta", "adam"):
            return {"h": tree_map(torch.zeros_like, params),
                    "h2": tree_map(torch.zeros_like, params)}
        raise ValueError(f"unknown solver_type {t}")

    def _mults(self, params):
        if self.spec is None:
            ones = tree_map(lambda p: 1.0, params)
            return ones, ones
        return (tree_map(lambda s: s[0], self.spec),
                tree_map(lambda s: s[1], self.spec))

    @torch.no_grad()
    def apply(self, params, grads, opt_state, step):
        cfg = self.cfg
        lr_mult, decay_mult = self._mults(params)
        device = tree_leaves(params)[0].device

        # 2. global L2 clip on the raw gradients
        if cfg.clip_gradients >= 0:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)))
            scale = torch.where(gnorm > cfg.clip_gradients,
                                cfg.clip_gradients / gnorm,
                                torch.ones_like(gnorm))
            grads = tree_map(lambda g: g * scale, grads)

        # 3. iter_size normalization
        if cfg.iter_size != 1:
            grads = tree_map(lambda g: g / cfg.iter_size, grads)

        # 4. weight decay into the gradient (decay_mult 0 adds exactly 0)
        if cfg.weight_decay:
            if cfg.regularization_type == "L2":
                decay = lambda p: p                              # noqa: E731
            elif cfg.regularization_type == "L1":
                decay = torch.sign
            else:
                raise ValueError(cfg.regularization_type)
            grads = tree_map(
                lambda g, p, d: g + (cfg.weight_decay * d) * decay(p)
                if d else g, grads, params, decay_mult)

        # 1./5. rate and update rule
        rate = learning_rate(cfg, step, device)
        t = cfg.solver_type
        h_old = opt_state["h"]
        if t in ("sgd", "nesterov"):
            m = cfg.momentum
            h = tree_map(lambda h_, g, l: m * h_ + rate * l * g,
                         h_old, grads, lr_mult)
            diff = h if t == "sgd" else tree_map(
                lambda hn, ho: (1 + m) * hn - m * ho, h, h_old)
            new_state = {"h": h}
        elif t in ("adagrad", "rmsprop"):
            if t == "adagrad":
                h = tree_map(lambda h_, g: h_ + g * g, h_old, grads)
            else:
                rd = cfg.rms_decay
                h = tree_map(lambda h_, g: (1 - rd) * g * g + rd * h_,
                             h_old, grads)
            diff = tree_map(
                lambda g, h_, l: rate * l * g / (torch.sqrt(h_) + cfg.delta),
                grads, h, lr_mult)
            new_state = {"h": h}
        elif t == "adadelta":
            m, eps = cfg.momentum, cfg.delta
            h = tree_map(lambda h_, g: (1 - m) * g * g + m * h_, h_old, grads)
            u = tree_map(
                lambda g, h_, h2: g * torch.sqrt((h2 + eps) / (h_ + eps)),
                grads, h, opt_state["h2"])
            h2 = tree_map(lambda h2_, u_: (1 - m) * u_ * u_ + m * h2_,
                          opt_state["h2"], u)
            diff = tree_map(lambda u_, l: rate * l * u_, u, lr_mult)
            new_state = {"h": h, "h2": h2}
        elif t == "adam":
            b1, b2, eps = cfg.momentum, cfg.momentum2, cfg.delta
            tt = torch.as_tensor(step, dtype=torch.float32,
                                 device=device) + 1.0
            corr = torch.sqrt(1.0 - b2 ** tt) / (1.0 - b1 ** tt)
            m_t = tree_map(lambda m_, g: (1 - b1) * g + b1 * m_, h_old, grads)
            v_t = tree_map(lambda v_, g: (1 - b2) * g * g + b2 * v_,
                           opt_state["h2"], grads)
            diff = tree_map(
                lambda m_, v_, l: rate * corr * l * m_
                / (torch.sqrt(v_) + eps), m_t, v_t, lr_mult)
            new_state = {"h": m_t, "h2": v_t}
        else:
            raise ValueError(t)

        # 6. data -= diff
        return tree_map(lambda p, d: p - d, params, diff), new_state


def make_solver(cfg: SolverConfig, spec=None) -> Solver:
    """spec: optional tree (same structure as params) of (lr_mult,
    decay_mult) tuples, the ParamSpec equivalent (``models.param_spec``)."""
    return Solver(cfg, spec)
