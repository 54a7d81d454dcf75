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
* snapshots every ``snapshot_interval`` steps to <dir>/<prefix>_iter_<N>/
  (``training/checkpoint.py``, the JAX package's layout), ``resume_from``
  and ``weights`` (`caffe train -snapshot` / `-weights`), which also take
  the reference's ``.solverstate`` and ``.caffemodel`` files
  (``utils/caffemodel.py``)
* a deterministic reshuffle of the training set each pass, the
  HDF5DataLayer shuffle equivalent (hdf5_data_layer.cpp:55-68)
* ``fit_stream``: the same loop over a batch iterator (``data/loader.py``,
  the packed store's ``NativePrefetcher``) with patience counted in evals
* chunks of up to ``steps_per_dispatch`` steps, each one dispatch: on the
  card one replay of a CUDA graph captured around the chunk's steps
  (``training/dispatch.py``, the counterpart of the JAX package's fused
  ``lax.scan``), on the CPU the same steps run eagerly.
* the eval step (forward and metrics of one split) as one CUDA graph
  replay on the card (``utils/graphs.py``, the counterpart of the JAX
  package's ``jax.jit(eval_step)``): a graph per split shape, reading the
  chunk runner's carry in place inside the loop and copies made on entry
  in ``evaluate``; the host reads the metrics after the replay.

Randomness: dropout draws from a ``torch.Generator`` on the training device
seeded from (seed, step[, micro-batch]); the shuffle of a pass from a CPU
generator seeded from (seed, epoch index).  A run is thus a function of
its seed and step, so a run resumed from a snapshot at step k repeats the
uninterrupted run bit for bit on the CPU.  The draws differ from the JAX
package's for the same seed.

``mesh``: data parallelism over a ``parallel.make_mesh`` mesh.  Every rank
runs this loop on the same global batches and takes its rows of each (the
sample axis, axis 1 under iter_size > 1); BN takes the global batch's
statistics, dropout draws the global batch's masks, and the gradients are
all-reduced to the global-batch mean, so the run is the one-device run's.
Parameters are replicated; rank 0 writes the snapshots.  On an NCCL mesh
each chunk and each eval is one graph replay as without a mesh: a chunk's
collectives (the BN sums and the gradient all-reduce) are captured with it,
every rank capturing at the same call, and an eval runs none, so a rank
may evaluate alone.  On a gloo mesh both run eagerly
(``utils/graphs.captures_on``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
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
from ..parallel.mesh import mesh_device, shard_context
from ..parallel.train_step import local_batch, loss_and_grads, reduce_grads
from ..utils.graphs import GraphedCall, captures_on
from ..utils.seed import derive_seed
from ..utils.timer import span
from ..utils.tree import tree_map
from .dispatch import ChunkRunner, _copy_tree, _same_leaves
from .checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_weights_into,
    restore,
    save_checkpoint,
)
from .optim import SolverConfig, make_solver

# above this eval-split size the O(N^2) pairwise-rank metrics give way to
# the O(N log N) sorted forms (identical numerics, same tie rule)
_SORTED_METRICS_THRESHOLD = 2048

# seed-derivation tags, so dropout and shuffle streams never coincide
_DROPOUT, _SHUFFLE = 1, 2

_SOLVERSTATES = (".solverstate", ".solverstate.h5")

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


def _new_history(cfg: TrainerConfig) -> dict:
    return {"train_loss_record_interval": cfg.train_loss_record_interval,
            "train_loss": [], "dev_map": [], "dev_mrr": [], "dev_auc": [],
            "test_map": [], "test_mrr": [], "test_auc": [], "steps": []}


class _EpochStop:
    """``fit``'s stop rule (QA-script semantics, do_trec_qa_clean.py:
    826-838): epochs counted from the samples each step consumed, the
    first boundary counted at once (``epoch`` starts at -1), a stop after
    ``early_stop_patience`` epochs without a better dev MAP."""

    def __init__(self, cfg: TrainerConfig, train_size: int, epoch: int,
                 wait_epoch: int):
        self.cfg, self.train_size = cfg, train_size
        self.samples_per_step = cfg.batch_size * cfg.solver.iter_size
        self.epoch, self.wait_epoch = epoch, wait_epoch

    def evaluated(self, improved: bool) -> bool:
        if improved:
            self.wait_epoch = 0
        return False

    def stepped(self, it: int) -> bool:
        if it * self.samples_per_step < self.epoch * self.train_size:
            return False
        self.epoch += 1
        self.wait_epoch += 1
        # early stop needs a dev signal; with test_interval 0 ("never
        # test") train to max_iter
        if self.cfg.test_interval \
                and self.wait_epoch > self.cfg.early_stop_patience:
            log.info("Epoch-%d [%d] early stop", self.epoch, it)
            return True
        return False

    def meta(self) -> dict:
        return {"epoch": self.epoch, "wait_epoch": self.wait_epoch}


class _EvalPatience:
    """``fit_stream``'s stop rule: a stop after ``patience`` evals without
    a better dev MAP (``None``: never); an iterator has no epoch."""

    def __init__(self, patience: int | None, waited: int):
        self.patience, self.waited = patience, waited

    def evaluated(self, improved: bool) -> bool:
        if improved:
            self.waited = 0
            return False
        self.waited += 1
        return self.patience is not None and self.waited > self.patience

    def stepped(self, it: int) -> bool:
        return False

    def meta(self) -> dict:
        return {"wait_epoch": self.waited, "stream": True}


class Trainer:
    """Couples a model config with a solver into train and eval steps on
    one device (``None`` means CUDA; the CPU runs only when asked for).

    ``apply_fn`` / ``init_fn``: the model, by default the QA model.
    ``apply_fn(params, state, batch, model_cfg, train=, generator=)``
    returns ({'loss', ...}, new_state); ``init_fn(model_cfg, generator=,
    device=[, pretrained=])`` returns (params, state), ``pretrained``
    passed only when given (the image-pair model takes none).  Evaluation
    reads ``out['prob']``, so it stays the QA model's.

    ``mesh``: a ``parallel.make_mesh`` mesh whose 'dp' axis splits each
    batch (see the module docstring); the device is then this rank's.
    Over more than one dp rank ``apply_fn`` must take ``shards=``.

    ``donate``: the JAX package's keyword, whose jitted steps take the
    caller's params and solver state as buffers to overwrite.  This port
    never consumes a caller's inputs: every chunk copies them into the
    runner's own static carry and returns clones (``scan_train_steps``),
    so both values give the same results and leave the inputs intact."""

    def __init__(self, model_cfg: MMSQAConfig, cfg: TrainerConfig, *,
                 device=None, mesh=None, apply_fn: Callable = mms_qa_apply,
                 init_fn: Callable = mms_qa_init, donate: bool = True):
        self.model_cfg = model_cfg
        self.cfg = cfg
        del donate
        self.mesh = mesh
        self._shards = shard_context(mesh).without_tp()  # tp: replicas
        if mesh is not None and device is None:
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.init_fn = init_fn
        self.solver = None  # built in init() when the spec exists
        # the chunk runner of the last carry trained (static carry, graphs)
        self.runner: ChunkRunner | None = None
        # chunks and evals as graph replays: on the card, over no mesh or
        # an NCCL one (eager on the CPU and over gloo)
        self.captures = captures_on(self.device, mesh, "trainer")
        # the eval step runs no collective: no mesh, so that one rank may
        # evaluate alone (the others gone, as after ``cli train``)
        self.evals = GraphedCall(self.device, captures=self.captures,
                                 name="eval step")
        self._eval_carry = None   # evaluate's static copies

    # ------------------------------------------------------------------ init
    def init(self, *, pretrained=None):
        extra = {} if pretrained is None else {"pretrained": pretrained}
        params, state = self.init_fn(
            self.model_cfg, generator=torch.Generator().manual_seed(
                self.cfg.seed), device=self.device, **extra)
        self.solver = make_solver(self.cfg.solver,
                                  param_spec(params, self.model_cfg))
        return params, state, self.solver.init(params)

    # ----------------------------------------------------------------- steps
    def _dropout_seed(self, *ints) -> int:
        """The dropout seed of a step, or of a step's micro-batch."""
        return derive_seed(self.cfg.seed, _DROPOUT, *ints)

    def _generator(self, *ints):
        return torch.Generator(device=self.device).manual_seed(
            self._dropout_seed(*ints))

    def _loss_and_grads(self, params, state, batch, generator):
        loss, new_state, grads = loss_and_grads(
            self.apply_fn, params, state, batch, self.model_cfg, generator,
            self._shards)
        grads, loss = reduce_grads(grads, loss, self._shards)
        it = iter(grads)
        return loss, new_state, tree_map(lambda _: next(it), params)

    def _train_step(self, params, state, opt_state, batch, step,
                    generators=None):
        """One solver step.  With ``iter_size`` > 1 every batch leaf carries
        a leading micro-batch axis; the gradients are summed over the
        micro-batches (the solver divides by iter_size) and the loss is
        their mean.  Over a mesh ``batch`` is the global batch, of which
        this rank takes its rows.  Returns (params, state, opt_state, loss
        0-d tensor).

        ``step``: an int, or a 0-d integer tensor on the device (a captured
        chunk computes its steps there); ``generators``: the iter_size
        dropout generators, seeded with ``_dropout_seed(step[, i])``
        (needed with a tensor ``step``; made from ``step`` if not given)."""
        iter_size = self.cfg.solver.iter_size
        batch = local_batch(batch, self._shards, 0 if iter_size == 1 else 1)
        if generators is None:
            generators = [self._generator(step)] if iter_size == 1 else \
                [self._generator(step, i) for i in range(iter_size)]
        if iter_size == 1:
            loss, state, grads = self._loss_and_grads(
                params, state, batch, generators[0])
        else:
            losses, grads = [], None
            for i in range(iter_size):
                loss_i, state, g = self._loss_and_grads(
                    params, state, {k: v[i] for k, v in batch.items()},
                    generators[i])
                losses.append(loss_i)
                grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = torch.stack(losses).mean()
        params, opt_state = self.solver.apply(params, grads, opt_state, step)
        return params, state, opt_state, loss

    def _eval_step(self, params, state, batch):
        """Forward and metrics of one full split: on the card one replay of
        the graph of this batch's shapes, reading ``params`` and ``state``
        in place (their addresses join the key: the runner's static carry,
        or ``evaluate``'s copies) and ``batch`` from its static copy.
        Returns fresh tensors."""
        return self.evals(("eval",), lambda b: self._eval_body(
            params, state, b), batch, fixed=(params, state))

    @torch.no_grad()
    def _eval_body(self, params, state, batch):
        out, _ = self.apply_fn(params, state, batch, self.model_cfg,
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
        tensors) in ONE dispatch, step ``step0 + i`` on slice i, as K
        ``_train_step`` calls do: on the card (over no mesh or an NCCL one)
        one replay of the CUDA graph of K-step chunks, captured the first
        time K runs (``training/dispatch.py``); on the CPU, and over a
        gloo mesh, the same steps run eagerly and give the step loop's
        bits.  The inputs are
        left untouched.  Returns (params, state, opt_state, losses (K,)
        tensor), copies that no later chunk overwrites."""
        runner = self._runner_for((params, state, opt_state))
        losses = runner.run(batches, int(step0))
        return (*runner.snapshot(), losses.clone())

    def _runner_for(self, carry) -> ChunkRunner:
        """The chunk runner with ``carry`` loaded into its static carry:
        the last one when the carry fits it (its captured graphs kept),
        else a new one."""
        if self.runner is not None and self.runner.fits(carry):
            self.runner.load(carry)
        else:
            self.runner = ChunkRunner(self, carry)
            self.evals.drop()   # graphs keyed on the old carry's addresses
        return self.runner

    @staticmethod
    def _plan_chunk(it: int, k: int, limit: int, intervals) -> int:
        """Length of the next chunk starting at step ``it``: at most ``k``
        and ``limit`` steps, and always ending exactly at the next multiple
        of any bookkeeping interval (so an eval or snapshot step is a
        chunk's LAST step, where the params are the post-that-step
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

    # --------------------------------------------------------------- restore
    def _resolve_ckpt(self, path: str) -> str:
        """A concrete checkpoint dir, or a snapshot root (-> its latest
        checkpoint), like `caffe train -snapshot`."""
        if os.path.exists(os.path.join(path, "ckpt.msgpack")):
            return path
        latest = latest_checkpoint(path, prefix=self.cfg.snapshot_prefix)
        if latest is None and self.cfg.snapshot_prefix != "qa":
            latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return latest

    def _load_weights(self, params, state, weights: str):
        """The `caffe train -weights` finetune load: a name+shape-checked
        partial restore from a checkpoint directory, or, when the path is a
        file, from a reference .caffemodel (binaryproto or HDF5 by the
        file's magic, Net::CopyTrainedLayersFrom, net.cpp:741-844)."""
        if os.path.isfile(weights):
            from ..utils.caffemodel import load_caffemodel_auto
            params, state, report = load_caffemodel_auto(weights, params,
                                                         state)
            log.info("finetune: %d tensors from caffemodel %s",
                     sum(v == "loaded" for v in report.values()), weights)
            return params, state
        params, state, report = load_weights_into(
            params, state, self._resolve_ckpt(weights))
        skipped = {k: v for k, v in report.items() if v != "loaded"}
        log.info("finetune: loaded %d/%d leaves from %s%s",
                 len(report) - len(skipped), len(report), weights,
                 f", skipped {sorted(skipped)}" if skipped else "")
        return params, state

    def _resume_solverstate(self, path, params, state, opt_state):
        """Resume a reference run: the solver history and the iteration
        from a .solverstate, the weights from its learned_net
        (Solver::Restore, solver.cpp:470-481).  The file records no epoch
        or early-stop counters; the caller re-derives the epoch and the
        patience clock restarts."""
        from ..utils.caffemodel import load_solverstate
        opt_state, it, _cur, learned, report = load_solverstate(
            path, params, state, opt_state)
        if learned:
            lp = learned if os.path.isabs(learned) else os.path.join(
                os.path.dirname(path) or ".", learned)
            if os.path.exists(lp):
                params, state = self._load_weights(params, state, lp)
            else:
                log.warning("solverstate names learned_net %s which does "
                            "not exist; weights stay at init", learned)
        log.info("resumed from reference solverstate %s: iter %d, %d "
                 "history tensors", path, it,
                 sum(v == "loaded" for v in report.values()))
        return params, state, opt_state, {"step": it - 1,
                                          "solverstate": True}

    def _resume(self, resume_from, params, state, opt_state, history, best):
        """Restore params, BN state, solver history, the loop counters and
        the history from a snapshot, and the best params from their own
        snapshot; or from a reference .solverstate.  Returns (params,
        state, opt_state, meta)."""
        if resume_from.endswith(_SOLVERSTATES):
            return self._resume_solverstate(resume_from, params, state,
                                            opt_state)
        ckpt = self._resolve_ckpt(resume_from)
        template = {"params": params, "state": state, "opt_state": opt_state}
        bundle, meta = load_checkpoint(ckpt, template=template)
        best["dev_map"] = float(meta.get("best_dev_map", -1.0))
        best["step"] = int(meta.get("best_step", 0))
        for k, v in (meta.get("history") or {}).items():
            if k in history:
                history[k] = v
        # the best-so-far params live in their own snapshot; reload them so
        # the run returns the true best, not the best since the resume
        # (the reference's script reloads the best snapshot the same way,
        # do_trec_qa_clean.py:840)
        if self.cfg.snapshot_dir:
            bp = os.path.join(self.cfg.snapshot_dir,
                              f"{self.cfg.snapshot_prefix}_iter_"
                              f"{best['step']}")
            if os.path.exists(os.path.join(bp, "ckpt.msgpack")):
                bb, _ = load_checkpoint(bp)
                best["params"] = restore(params, bb["params"], "params")
                best["state"] = restore(state, bb["state"], "state")
        log.info("resumed from %s at iter %d, best dev MAP %.4f @ %d", ckpt,
                 int(meta.get("step", -1)) + 1, best["dev_map"], best["step"])
        return bundle["params"], bundle["state"], bundle["opt_state"], meta

    def _snapshot(self, it, params, state, opt_state, history, best,
                  **meta):
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return  # replicated params: rank 0 writes them
        with span("fit.snapshot"):
            save_checkpoint(
                self.cfg.snapshot_dir, it,
                {"params": params, "state": state, "opt_state": opt_state},
                prefix=self.cfg.snapshot_prefix,
                meta={"dev_map": history["dev_map"][-1]
                      if history["dev_map"] else None,
                      **meta, "best_step": best["step"],
                      "best_dev_map": best["dev_map"], "history": history})

    def _record_eval(self, it, params, state, dev_batch, test_batch,
                     history) -> float:
        """Eval on dev (and test) at step ``it``, appended to the history;
        returns the dev MAP.  One ``fit.eval`` span: each split's replay
        (``eval.dispatch``) and its three blocking reads (``eval.read``)."""
        with span("fit.eval"):
            splits = [("dev", dev_batch)] + (
                [("test", test_batch)] if test_batch is not None else [])
            for split, batch in splits:
                with span("eval.dispatch"):
                    out = self._eval_step(params, state, batch)
                with span("eval.read"):
                    for m in ("map", "mrr", "auc"):
                        history[f"{split}_{m}"].append(float(out[m]))
        history["steps"].append(it)
        return history["dev_map"][-1]

    @staticmethod
    def _finish(history, best, params, state):
        """The history with the best params and state, or copies of the
        last ones (the static carry, which a later chunk overwrites)."""
        history["best_step"] = best["step"]
        history["best_dev_map"] = best["dev_map"]
        history["params"] = best["params"] if best["params"] is not None \
            else tree_map(torch.clone, params)
        history["state"] = best["state"] if best["state"] is not None \
            else tree_map(torch.clone, state)
        return history

    # ------------------------------------------------------------------ loop
    def _loop(self, pull, carry, it: int, steps: int, *, stop_rule,
              eval_interval, dev_batch, test_batch, history, best,
              log_every, callback, handle_signals, steps_per_dispatch,
              what: str):
        """The loop ``fit`` and ``fit_stream`` share: steps ``it`` to
        ``steps - 1`` on the batches ``pull()`` returns (StopIteration ends
        the run after the partial chunk), dev (and test) evals every
        ``eval_interval`` steps with the best params kept in ``best``,
        snapshots, signals.  ``stop_rule`` decides the early stop and the
        snapshots' meta.

        Chunks of up to ``steps_per_dispatch`` steps end at every eval and
        snapshot step; each is one ``ChunkRunner.run`` on the runner's
        static carry (one graph replay on the card), its losses copied to
        the host once.  The best params are copies taken at their eval.
        Each chunk is one ``fit.chunk`` span, its first step the id of
        every span inside: ``fit.pull`` (its batches), the runner's
        ``chunk.stage`` and ``chunk.replay``, ``fit.read`` (the losses'
        copy) and ``fit.steps`` (the bookkeeping, around any ``fit.eval``,
        ``fit.callback`` and ``fit.snapshot``).
        Returns the history dict."""
        from .signals import Action, SignalHandler
        cfg = self.cfg
        runner = self._runner_for(carry)
        params, state, opt_state = runner.carry
        intervals = [eval_interval] if eval_interval else []
        if cfg.snapshot_dir and cfg.snapshot_interval:
            intervals.append(cfg.snapshot_interval)
        t0 = time.time()
        stop = exhausted = False
        sig_ctx = SignalHandler() if handle_signals else None

        def pull_chunk(n: int) -> list:
            nonlocal exhausted
            batches = []
            for _ in range(n):
                try:
                    batches.append(pull())
                except StopIteration:
                    exhausted = True
                    break
            return batches

        def bookkeep(losses: list) -> None:
            """The per-step bookkeeping over a chunk; the planner puts
            every eval and snapshot step at a chunk's end, where the
            params are that step's."""
            nonlocal it, stop
            last_j = len(losses) - 1
            for j, loss in enumerate(losses):
                if it % cfg.train_loss_record_interval == 0:
                    history["train_loss"].append(loss)
                if log_every and it % log_every == 0:
                    log.info("%s %d loss %.4f (%.1fs)", what, it,
                             loss, time.time() - t0)
                if eval_interval and it % eval_interval == 0:
                    assert j == last_j, "chunk planner missed a boundary"
                    dev_map = self._record_eval(it, params, state,
                                                dev_batch, test_batch,
                                                history)
                    improved = dev_map > best["dev_map"]
                    if improved:
                        # copies: the next chunk overwrites the carry
                        best.update(dev_map=dev_map, step=it,
                                    params=tree_map(torch.clone, params),
                                    state=tree_map(torch.clone, state))
                    stop |= stop_rule.evaluated(improved)
                    if callback:
                        with span("fit.callback"):
                            callback({"step": it, "dev_map": dev_map,
                                      "loss": loss})
                stop |= stop_rule.stepped(it)

                # snapshots after the stop rule's bookkeeping, so their
                # meta resumes exactly; signals are polled once a chunk
                snap_meta = stop_rule.meta()
                if sig_ctx is not None and j == last_j:
                    action = sig_ctx.get_requested_action()
                    if action != Action.NONE and cfg.snapshot_dir:
                        self._snapshot(it, params, state, opt_state,
                                       history, best, **snap_meta,
                                       signal=action.name)
                    if action == Action.STOP:
                        log.info("SIGINT: stop at %s %d", what, it)
                        stop = True
                if (cfg.snapshot_dir and cfg.snapshot_interval
                        and it % cfg.snapshot_interval == 0):
                    assert j == last_j, "chunk planner missed a boundary"
                    self._snapshot(it, params, state, opt_state, history,
                                   best, **snap_meta)
                it += 1
                if it >= steps or stop:
                    break

        if sig_ctx is not None:
            sig_ctx.__enter__()
        try:
            while it < steps and not stop and not exhausted:
                with span("fit.chunk", id=it):
                    with span("fit.pull"):
                        batches = pull_chunk(self._plan_chunk(
                            it, steps_per_dispatch, steps - it, intervals))
                    if not batches:
                        break
                    losses = runner.run(batches, it)
                    with span("fit.read"):
                        losses = losses.tolist()
                    with span("fit.steps"):
                        bookkeep(losses)
        finally:
            if sig_ctx is not None:
                sig_ctx.__exit__(None, None, None)
        return self._finish(history, best, params, state)

    # ------------------------------------------------------------------- fit
    def fit(self, train_data: dict, dev_data: dict, *, test_data: dict = None,
            pretrained=None, log_every: int | None = None,
            callback: Callable[[dict], None] | None = None,
            handle_signals: bool = False, resume_from: str | None = None,
            weights: str | None = None, steps_per_dispatch: int = 1):
        """Run the full training recipe on dicts of numpy arrays.  Returns
        a history dict with the best params and BN state (by dev MAP) and
        the metric curves, shaped as the JAX package's.

        handle_signals: SIGINT snapshots (with ``snapshot_dir``) and stops
        after the current chunk, SIGHUP snapshots and carries on (the
        reference's SignalHandler contract, solver.cpp:259-272).

        resume_from: a checkpoint dir, or a snapshot root (-> its latest),
        to restore params, BN state, solver history, step, epoch and the
        early-stop counters from; the resumed run repeats the
        uninterrupted one (the same shuffles and dropout draws).  Or a
        reference .solverstate[.h5]: solver history, iteration and its
        learned_net's weights; the epoch follows from the iteration and
        the patience clock restarts.

        weights: a checkpoint dir, or a reference .caffemodel[.h5] file, to
        partial-load params and BN state from by name and shape before
        training (`caffe train -weights`).  Mutually exclusive with
        resume_from.

        steps_per_dispatch: chunks of up to K steps, ending at eval and
        snapshot steps, as the JAX package plans its fused dispatches; on
        the card each chunk is one CUDA graph replay (``scan_train_steps``;
        each chunk length is captured once), on the CPU its steps run
        eagerly and the history is that of K = 1, bit for bit.  Signals
        are polled once a chunk.
        """
        if resume_from and weights:
            raise ValueError("resume_from and weights are mutually exclusive "
                             "(tools/caffe.cpp:208-210 has the same CHECK)")
        cfg = self.cfg
        with span("fit.init"):
            params, state, opt_state = self.init(pretrained=pretrained)
        if weights:
            params, state = self._load_weights(params, state, weights)
        with span("fit.upload"):
            train = self._full_batch({k: v for k, v in train_data.items()
                                      if k != "group"})
            dev_batch = self._full_batch(dev_data)
            test_batch = self._full_batch(test_data) if test_data else None

        history = _new_history(cfg)
        best = {"dev_map": -1.0, "step": 0, "params": None, "state": None}
        train_size = len(train_data["label"])
        samples_per_step = cfg.batch_size * cfg.solver.iter_size
        steps_per_pass = max(1, -(-train_size // samples_per_step))
        epoch, wait_epoch = -1, 0
        it = 0
        if resume_from:
            params, state, opt_state, meta = self._resume(
                resume_from, params, state, opt_state, history, best)
            it = int(meta.get("step", -1)) + 1
            epoch = int(meta.get("epoch", -1))
            if meta.get("solverstate"):
                epoch = (it * samples_per_step) // max(train_size, 1)
            wait_epoch = int(meta.get("wait_epoch", 0))

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

        return self._loop(
            batch_stream(it).__next__, (params, state, opt_state), it,
            cfg.max_iter, stop_rule=_EpochStop(cfg, train_size, epoch,
                                               wait_epoch),
            eval_interval=cfg.test_interval, dev_batch=dev_batch,
            test_batch=test_batch, history=history, best=best,
            log_every=log_every, callback=callback,
            handle_signals=handle_signals,
            steps_per_dispatch=steps_per_dispatch, what="iter")

    # ---------------------------------------------------------------- stream
    def fit_stream(self, batches, dev_data: dict, *, steps: int,
                   test_data: dict = None,
                   params=None, state=None, opt_state=None, pretrained=None,
                   eval_interval: int | None = None,
                   patience_evals: int | None = None,
                   handle_signals: bool = False,
                   resume_from: str | None = None,
                   weights: str | None = None,
                   log_every: int | None = None,
                   callback: Callable[[dict], None] | None = None,
                   steps_per_dispatch: int = 1):
        """Train from a batch iterator (``BatchIterator``,
        ``NativePrefetcher`` or any iterator of dicts of arrays) instead of
        in-memory splits: the streaming path for pools that do not fit
        host memory.  Early stopping counts evals without dev-MAP
        improvement (``patience_evals``): an iterator has no epoch.

        A ``NativePrefetcher`` hands each batch to the device through
        ``next_device`` (pinned staging, non-blocking copies on CUDA).
        Packed labels of shape (B, 1) become (B,); with iter_size > 1,
        iter_size consecutive batches stack into one step.

        Snapshots carry ``"stream": True``; ``resume_from`` restores
        params, solver history, step, best and history (the stream's
        position is the caller's to restore, as the reference's
        .solverstate records no data cursor either); ``weights`` is the
        finetune load.  Chunks of ``steps_per_dispatch`` end at eval and
        snapshot steps; an exhausted iterator ends the run after the
        partial chunk.  Returns the history dict of ``fit``."""
        if resume_from and weights:
            raise ValueError("resume_from and weights are mutually exclusive")
        cfg = self.cfg
        if params is None:
            with span("fit.init"):
                params, state, opt_state = self.init(pretrained=pretrained)
        if weights:
            params, state = self._load_weights(params, state, weights)
        eval_interval = eval_interval or cfg.test_interval
        with span("fit.upload"):
            dev_batch = self._full_batch(dev_data)
            test_batch = self._full_batch(test_data) if test_data else None
        history = _new_history(cfg)
        best = {"dev_map": -1.0, "step": 0, "params": None, "state": None}
        waited = 0
        it = 0
        if resume_from:
            params, state, opt_state, meta = self._resume(
                resume_from, params, state, opt_state, history, best)
            it = int(meta.get("step", -1)) + 1
            waited = int(meta.get("wait_epoch", 0))

        direct = hasattr(batches, "next_device")
        iter_size = cfg.solver.iter_size

        def pull_one():
            if direct:
                raw = batches.next_device(self.device)
            else:
                raw = {k: torch.as_tensor(np.asarray(v), device=self.device)
                       for k, v in next(batches).items()}
            b = {k: v for k, v in raw.items() if k != "group"}
            if "label" in b and b["label"].ndim == 2:
                b["label"] = b["label"][:, 0]
            return b

        def pull():
            if iter_size == 1:
                return pull_one()
            # gradient accumulation: iter_size consecutive stream batches
            # on a leading micro-batch axis, the shape fit() steps take
            micro = [pull_one() for _ in range(iter_size)]
            return {k: torch.stack([m[k] for m in micro]) for k in micro[0]}

        return self._loop(
            pull, (params, state, opt_state), it, steps,
            stop_rule=_EvalPatience(patience_evals, waited),
            eval_interval=eval_interval, dev_batch=dev_batch,
            test_batch=test_batch, history=history, best=best,
            log_every=log_every, callback=callback,
            handle_signals=handle_signals,
            steps_per_dispatch=steps_per_dispatch, what="stream iter")

    # ------------------------------------------------------------- inference
    def evaluate(self, params, state, data: dict):
        """Full-split eval (the `caffe test` path): one batch, on-device
        metrics, probabilities and metrics back to the host as numpy.
        ``params`` and ``state`` are copied into the trainer's static
        buffers first (one eval graph per split shape)."""
        carry = tree_map(lambda t: torch.as_tensor(t).to(self.device),
                         {"params": params, "state": state})
        if self._eval_carry is None \
                or not _same_leaves(self._eval_carry, carry):
            self._eval_carry = tree_map(torch.clone, carry)
            self.evals.drop()   # graphs keyed on the old copies' addresses
        else:
            _copy_tree(self._eval_carry, carry)
        out = self._eval_step(self._eval_carry["params"],
                              self._eval_carry["state"],
                              self._full_batch(data))
        return {k: v.cpu().numpy() for k, v in out.items() if v is not None}
