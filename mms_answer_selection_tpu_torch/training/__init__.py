from .optim import (  # noqa: F401
    Solver,
    SolverConfig,
    learning_rate,
    make_solver,
)
from .signals import Action, SignalHandler  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
