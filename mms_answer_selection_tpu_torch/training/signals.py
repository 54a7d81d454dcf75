"""Signal-driven stop / snapshot (the reference's failure-handling model;
a copy of the JAX package's ``training/signals.py``).

Reference: util/signal_handler.cpp + tools/caffe.cpp:44-49 -- SIGINT maps
to STOP (snapshot then exit the train loop gracefully), SIGHUP to SNAPSHOT
(checkpoint and continue); the solver polls the flag once per iteration
(solver.cpp:259-272).  Same contract here: handlers only set
sig_atomic-style flags, the Trainer polls between steps, and nothing
signal-unsafe runs in handler context.
"""

from __future__ import annotations

import enum
import signal


class Action(enum.Enum):
    NONE = 0
    STOP = 1       # snapshot and break out of the train loop
    SNAPSHOT = 2   # snapshot and continue


class SignalHandler:
    """Install with ``with SignalHandler() as h:`` around a train loop and
    call ``h.get_requested_action()`` once per step (it clears SNAPSHOT but
    latches STOP, as the reference does)."""

    def __init__(self, stop_signal=signal.SIGINT, snapshot_signal=signal.SIGHUP):
        self.stop_signal = stop_signal
        self.snapshot_signal = snapshot_signal
        self._stop = False
        self._snapshot = False
        self._saved = {}

    def _on_stop(self, signum, frame):
        self._stop = True

    def _on_snapshot(self, signum, frame):
        self._snapshot = True

    def __enter__(self):
        for sig, fn in ((self.stop_signal, self._on_stop),
                        (self.snapshot_signal, self._on_snapshot)):
            if sig is not None:
                self._saved[sig] = signal.signal(sig, fn)
        return self

    def __exit__(self, *exc):
        for sig, old in self._saved.items():
            signal.signal(sig, old)
        return False

    def get_requested_action(self) -> Action:
        if self._stop:
            return Action.STOP
        if self._snapshot:
            self._snapshot = False
            return Action.SNAPSHOT
        return Action.NONE
