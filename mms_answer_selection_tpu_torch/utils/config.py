"""Experiment configs as versioned JSON (counterpart of ``utils/config.py``):
the prototxt/SolverParameter replacement.

``experiment_to_json`` writes the port's ``MMSQAConfig`` and
``TrainerConfig`` (with its ``SolverConfig``) under ``config_version``; for
the same configs the text is the JAX package's, so a ``config.json``
moves between the two packages.  ``experiment_from_json`` runs the
registered migrations first (v0 files had no version field), the
upgrade_proto idea without its legacy baggage.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

from ..models.mms_qa import ConvBlock, MMSQAConfig
from ..training.optim import SolverConfig
from ..training.trainer import TrainerConfig

CONFIG_VERSION = 1

# version -> migration fn(dict) -> dict bumping it one version
_MIGRATIONS: dict[int, Callable[[dict], dict]] = {}


def register_migration(from_version: int):
    def deco(fn):
        _MIGRATIONS[from_version] = fn
        return fn
    return deco


def _to_dict(obj) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(x) for x in obj]
    return obj


def experiment_to_json(model: MMSQAConfig, trainer: TrainerConfig) -> str:
    return json.dumps({
        "config_version": CONFIG_VERSION,
        "model": _to_dict(model),
        "trainer": _to_dict(trainer),
    }, indent=2)


def experiment_from_json(text: str) -> tuple[MMSQAConfig, TrainerConfig]:
    raw = json.loads(text)
    version = raw.get("config_version", 0)
    if version > CONFIG_VERSION:
        raise ValueError(
            f"config_version {version} is newer than this code's "
            f"{CONFIG_VERSION}; upgrade the package to read it")
    while version < CONFIG_VERSION:
        if version not in _MIGRATIONS:
            raise ValueError(f"no migration from config_version {version}")
        raw = _MIGRATIONS[version](raw)
        version += 1
    model_raw = dict(raw["model"])
    model_raw["blocks"] = tuple(ConvBlock(*b) if isinstance(b, list)
                                else ConvBlock(**b)
                                for b in model_raw["blocks"])
    trainer_raw = dict(raw["trainer"])
    solver_raw = dict(trainer_raw.pop("solver"))
    solver_raw["stepvalues"] = tuple(solver_raw.get("stepvalues", ()))
    trainer = TrainerConfig(solver=SolverConfig(**solver_raw), **trainer_raw)
    return MMSQAConfig(**model_raw), trainer


@register_migration(0)
def _v0_to_v1(raw: dict) -> dict:
    """v0 files had no explicit version field; fields are identical."""
    raw = dict(raw)
    raw["config_version"] = 1
    return raw
