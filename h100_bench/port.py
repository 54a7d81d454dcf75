"""The bridge to the system under test: the port's configuration objects
built from a configuration file, and the weights the serving cells hand
it.  The runners import the port only through here and through the
entry points they time."""

from __future__ import annotations

import torch

from . import traffic


def model_config(cfg: dict):
    """The port's ``MMSQAConfig`` of a configuration file."""
    from mms_answer_selection_tpu_torch.models.mms_qa import (
        ConvBlock, MMSQAConfig)

    keys = ("vocab_size", "embed_dim", "question_len", "answer_len",
            "sim_mode", "sim_measures", "sim_bias", "sim_dropout",
            "overlap_features", "fc1_dim", "fc1_dropout", "num_classes",
            "embed_init_range", "sim_weight_init", "bn_shift_init")
    return MMSQAConfig(blocks=tuple(ConvBlock(*b) for b in cfg["blocks"]),
                       **{k: cfg[k] for k in keys})


def trainer_config(cfg: dict, tr: dict, seed: int, global_batch: int):
    """The recipe's ``TrainerConfig``: the configuration's solver, the
    mix's schedule, no snapshots, the run's seed."""
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, TrainerConfig)

    return TrainerConfig(solver=SolverConfig(**cfg["solver"]),
                         max_iter=int(tr["max_iter"]),
                         batch_size=global_batch,
                         test_interval=int(tr["test_interval"]),
                         early_stop_patience=int(tr["early_stop_patience"]),
                         seed=int(seed), snapshot_dir=None)


def serving_weights(cfg: dict, seed: int, device) -> dict:
    """What the engine scores with, made on the device from the seed: the
    embedding table and its bias, uniform in +-``embed_init_range``, and
    the M metric matrices, xavier over D x D (a trained metric's scale)."""
    gen = traffic.generator(seed, traffic.WEIGHTS, device)
    v, d, m = cfg["vocab_size"], cfg["embed_dim"], cfg["sim_measures"]
    r, s = cfg["embed_init_range"], (3.0 / (d * d)) ** 0.5

    def uniform(shape, bound):
        x = torch.rand(shape, generator=gen, device=device)
        return x * (2 * bound) - bound

    return {"embed": {"w": uniform((v, d), r), "b": uniform((d,), r)},
            "sim": {"w": uniform((m, d, d), s)}}
