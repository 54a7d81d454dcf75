"""Training loop (counterpart of ``training/trainer.py``): the
Solver::Solve/Step and QA-script replacement.

Reproduces the control flow of the reference's hot loop (solver.cpp:194-323)
and of the QA script (do_trec_qa_clean.py:782-845):

* a train step = forward + backward + solver update on the device; with
  ``iter_size`` > 1 it accumulates the gradients of ``iter_size``
  micro-batches, threading the BN running statistics through them in order
* eval every ``test_interval`` steps over full splits with on-device
  MAP/MRR/AUC (metrics-as-net-outputs, do_trec_qa_clean.py:817-824)
* epoch-granular early stopping with patience on dev MAP
  (do_trec_qa_clean.py:826-838, including its quirk of counting the first
  epoch boundary immediately because ``epoch`` starts at -1)
* the best-dev-MAP params and BN state are kept and returned
* a deterministic reshuffle of the training set each pass, the
  HDF5DataLayer shuffle equivalent (hdf5_data_layer.cpp:55-68).

Randomness: dropout draws from a ``torch.Generator`` on the training device
seeded from (seed, step[, micro-batch]); the shuffle of a pass from a CPU
generator seeded from (seed, epoch index).  A run is thus a function of
its seed and step, which a resume can reproduce.  The draws differ from
the JAX package's for the same seed.

Not here yet: snapshots, ``resume_from`` and ``weights`` (they need a
checkpoint format; ROADMAP Queue 1 item 6), ``fit_stream`` and mesh
data parallelism.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..metrics import (
    auc_torch,
    auc_torch_sorted,
    mean_average_precision_torch,
    mean_average_precision_torch_sorted,
    mean_reciprocal_rank_torch,
    mean_reciprocal_rank_torch_sorted,
)
from ..models.mms_qa import MMSQAConfig, mms_qa_apply, mms_qa_init, param_spec
from ..utils.tree import tree_leaves, tree_map
from .optim import SolverConfig, make_solver

# above this eval-split size the O(N^2) pairwise-rank metrics give way to
# the O(N log N) sorted forms (identical numerics, same tie rule)
_SORTED_METRICS_THRESHOLD = 2048

# seed-derivation tags, so dropout and shuffle streams never coincide
_DROPOUT, _SHUFFLE = 1, 2

_NO_CHECKPOINTS = ("{} needs a checkpoint format, which the port does not "
                   "have yet (ROADMAP Queue 1 item 6: training/checkpoint.py)")

log = logging.getLogger("mms_tpu_torch.trainer")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """QA-script hyperparameters (do_trec_qa_clean.py:48-73)."""
    solver: SolverConfig = SolverConfig()
    max_iter: int = 40001
    batch_size: int = 50
    test_interval: int = 100
    snapshot_interval: int = 100
    display: int = 50
    train_loss_record_interval: int = 20
    early_stop_patience: int = 5      # epochs without dev-MAP improvement
    seed: int = 22
    snapshot_dir: str | None = None
    snapshot_prefix: str = "qa"


def derive_seed(*ints: int) -> int:
    """A 63-bit seed that is a fixed function of ``ints``."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class Trainer:
    """Couples a model config with a solver into train and eval steps on
    one device (``None`` means CUDA; the CPU runs only when asked for)."""

    def __init__(self, model_cfg: MMSQAConfig, cfg: TrainerConfig, *,
                 device=None):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.solver = None  # built in init() when the spec exists

    # ------------------------------------------------------------------ init
    def init(self, *, pretrained=None):
        params, state = mms_qa_init(
            self.model_cfg, generator=torch.Generator().manual_seed(
                self.cfg.seed), pretrained=pretrained, device=self.device)
        self.solver = make_solver(self.cfg.solver,
                                  param_spec(params, self.model_cfg))
        return params, state, self.solver.init(params)

    # ----------------------------------------------------------------- steps
    def _generator(self, *ints):
        return torch.Generator(device=self.device).manual_seed(
            derive_seed(self.cfg.seed, _DROPOUT, *ints))

    def _loss_and_grads(self, params, state, batch, generator):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        out, new_state = mms_qa_apply(p, state, batch, self.model_cfg,
                                      train=True, generator=generator)
        grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(x)
                  for g, x in zip(grads, leaves))
        return out["loss"].detach(), new_state, tree_map(lambda _: next(it),
                                                         params)

    def _train_step(self, params, state, opt_state, batch, step: int):
        """One solver step.  With ``iter_size`` > 1 every batch leaf carries
        a leading micro-batch axis; the gradients are summed over the
        micro-batches (the solver divides by iter_size) and the loss is
        their mean.  Returns (params, state, opt_state, loss 0-d tensor)."""
        iter_size = self.cfg.solver.iter_size
        if iter_size == 1:
            loss, state, grads = self._loss_and_grads(
                params, state, batch, self._generator(step))
        else:
            losses, grads = [], None
            for i in range(iter_size):
                loss_i, state, g = self._loss_and_grads(
                    params, state, {k: v[i] for k, v in batch.items()},
                    self._generator(step, i))
                losses.append(loss_i)
                grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = torch.stack(losses).mean()
        params, opt_state = self.solver.apply(params, grads, opt_state, step)
        return params, state, opt_state, loss

    @torch.no_grad()
    def _eval_step(self, params, state, batch):
        out, _ = mms_qa_apply(params, state, batch, self.model_cfg,
                              train=False)
        scores = out["prob"][:, 1]
        labels = batch["label"]
        res = {"prob": out["prob"], "loss": out.get("loss")}
        big = scores.shape[0] > _SORTED_METRICS_THRESHOLD
        if "group" in batch:
            groups = batch["group"]
            map_fn = mean_average_precision_torch_sorted if big \
                else mean_average_precision_torch
            mrr_fn = mean_reciprocal_rank_torch_sorted if big \
                else mean_reciprocal_rank_torch
            res["map"] = map_fn(scores, labels, groups)
            res["mrr"] = mrr_fn(scores, labels, groups)
        res["auc"] = (auc_torch_sorted if big else auc_torch)(scores, labels)
        return res

    # --------------------------------------------------------- multi-step
    def scan_train_steps(self, params, state, opt_state, batches, step0):
        """Run K training steps over ``batches`` (dict of (K, ...) stacked
        tensors), step ``step0 + i`` on slice i, exactly as K ``_train_step``
        calls do.  The JAX package fuses these into one compiled dispatch;
        here it is a plain loop, so ``fit`` steps one batch at a time
        instead.  Returns (params, state, opt_state, losses (K,) tensor)."""
        k = next(iter(batches.values())).shape[0]
        losses = []
        for i in range(k):
            batch = {n: v[i] for n, v in batches.items()}
            params, state, opt_state, loss = self._train_step(
                params, state, opt_state, batch, step0 + i)
            losses.append(loss)
        return params, state, opt_state, torch.stack(losses)

    @staticmethod
    def _plan_chunk(it: int, k: int, limit: int, intervals) -> int:
        """Length of the next ``scan_train_steps`` chunk starting at step
        ``it``: at most ``k`` and ``limit`` steps, and always ending exactly
        at the next multiple of any bookkeeping interval (so an eval step
        is a chunk's LAST step, where the params are the post-that-step
        state)."""
        k_plan = min(k, limit)
        for interval in intervals:
            nb = it + (-it) % interval  # next multiple >= it
            k_plan = min(k_plan, nb - it + 1)
        return max(1, k_plan)

    # ------------------------------------------------------------------ data
    def _epoch_batches(self, data: dict, epoch_index: int,
                       start_batch: int = 0):
        """One pass over ``data`` (dict of tensors on the device, no
        'group') in a shuffled order fixed by (seed, epoch_index);
        fixed-size batches with wrap-around, so every step sees the same
        shapes.  With iter_size > 1 each yield carries iter_size stacked
        micro-batches.  ``start_batch`` skips the first batches of the
        pass without materializing them."""
        n = len(data["label"])
        gen = torch.Generator().manual_seed(
            derive_seed(self.cfg.seed, _SHUFFLE, epoch_index))
        perm = torch.randperm(n, generator=gen).to(self.device)
        iter_size = self.cfg.solver.iter_size
        bs = self.cfg.batch_size * iter_size
        for start in range(start_batch * bs, n, bs):
            idx = perm[start: start + bs]
            if len(idx) < bs:  # wrap (HDF5DataLayer-style continuous stream)
                reps = perm.repeat(bs // n + 1)
                idx = torch.cat([idx, reps[: bs - len(idx)]])
            batch = {k: v[idx] for k, v in data.items()}
            if iter_size > 1:
                batch = {k: v.reshape((iter_size, self.cfg.batch_size)
                                      + tuple(v.shape[1:]))
                         for k, v in batch.items()}
            yield batch

    def _full_batch(self, data: dict):
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in data.items()}

    # ------------------------------------------------------------------- fit
    def fit(self, train_data: dict, dev_data: dict, *, test_data: dict = None,
            pretrained=None,
            callback: Callable[[dict], None] | None = None,
            handle_signals: bool = False, resume_from: str | None = None,
            weights: str | None = None):
        """Run the full training recipe on dicts of numpy arrays.  Returns
        a history dict with the best params and BN state (by dev MAP) and
        the metric curves, shaped as the JAX package's.

        handle_signals: SIGINT stops the run after the current step and
        SIGHUP is ignored, since there is nothing to snapshot to (the
        reference's SignalHandler contract, minus the snapshot).
        """
        from .signals import Action, SignalHandler
        for name, value in (("resume_from", resume_from),
                            ("weights", weights),
                            ("snapshot_dir", self.cfg.snapshot_dir)):
            if value:
                raise NotImplementedError(_NO_CHECKPOINTS.format(name))
        cfg = self.cfg
        params, state, opt_state = self.init(pretrained=pretrained)
        train = self._full_batch({k: v for k, v in train_data.items()
                                  if k != "group"})
        dev_batch = self._full_batch(dev_data)
        test_batch = self._full_batch(test_data) if test_data else None

        history = {"train_loss_record_interval":
                   cfg.train_loss_record_interval,
                   "train_loss": [], "dev_map": [], "dev_mrr": [],
                   "dev_auc": [], "test_map": [], "test_mrr": [],
                   "test_auc": [], "steps": []}
        best = {"dev_map": -1.0, "step": 0, "params": None, "state": None}
        train_size = len(train_data["label"])
        samples_per_step = cfg.batch_size * cfg.solver.iter_size
        steps_per_pass = max(1, -(-train_size // samples_per_step))
        epoch, wait_epoch = -1, 0
        stop = False
        it = 0

        def batch_stream(s_it):
            """Continuous batch stream across passes; each pass's shuffle
            uses the sample-count epoch index at the pass start."""
            while True:
                pass_start = (s_it // steps_per_pass) * steps_per_pass
                epoch_index = (pass_start * samples_per_step) \
                    // max(train_size, 1)
                for b in self._epoch_batches(train, epoch_index,
                                             start_batch=s_it - pass_start):
                    yield b
                    s_it += 1

        sig_ctx = SignalHandler() if handle_signals else None
        if sig_ctx is not None:
            sig_ctx.__enter__()
        try:
            stream = batch_stream(it)
            while it < cfg.max_iter and not stop:
                params, state, opt_state, loss = self._train_step(
                    params, state, opt_state, next(stream), it)
                if it % cfg.train_loss_record_interval == 0:
                    history["train_loss"].append(float(loss))

                if cfg.test_interval and it % cfg.test_interval == 0:
                    dev = self._eval_step(params, state, dev_batch)
                    dev_map = float(dev["map"])
                    history["dev_map"].append(dev_map)
                    history["dev_mrr"].append(float(dev["mrr"]))
                    history["dev_auc"].append(float(dev["auc"]))
                    history["steps"].append(it)
                    if test_batch is not None:
                        te = self._eval_step(params, state, test_batch)
                        history["test_map"].append(float(te["map"]))
                        history["test_mrr"].append(float(te["mrr"]))
                        history["test_auc"].append(float(te["auc"]))
                    if dev_map > best["dev_map"]:
                        wait_epoch = 0
                        # the solver and BN return new tensors each step,
                        # so references stay the post-step state
                        best = {"dev_map": dev_map, "step": it,
                                "params": params, "state": state}
                    if callback:
                        callback({"step": it, "dev_map": dev_map,
                                  "loss": float(loss)})

                # epoch accounting + early stop (QA-script semantics
                # :832-838), counting the samples each step consumed
                if it * samples_per_step >= epoch * train_size:
                    epoch += 1
                    wait_epoch += 1
                    # early stop needs a dev signal; with test_interval 0
                    # ("never test") train to max_iter
                    if cfg.test_interval \
                            and wait_epoch > cfg.early_stop_patience:
                        log.info("Epoch-%d [%d] early stop", epoch, it)
                        stop = True

                if sig_ctx is not None \
                        and sig_ctx.get_requested_action() == Action.STOP:
                    log.info("SIGINT: stop at iter %d", it)
                    stop = True
                it += 1
        finally:
            if sig_ctx is not None:
                sig_ctx.__exit__(None, None, None)
        history["best_step"] = best["step"]
        history["best_dev_map"] = best["dev_map"]
        history["params"] = best["params"] if best["params"] is not None \
            else params
        history["state"] = best["state"] if best["state"] is not None \
            else state
        return history

    # ------------------------------------------------------------- inference
    def evaluate(self, params, state, data: dict):
        """Full-split eval (the `caffe test` path): one batch, on-device
        metrics, probabilities and metrics back to the host as numpy."""
        out = self._eval_step(params, state, self._full_batch(data))
        return {k: v.cpu().numpy() for k, v in out.items() if v is not None}
