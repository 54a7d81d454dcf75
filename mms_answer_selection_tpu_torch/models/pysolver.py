"""pycaffe-style ``Solver`` (counterpart of ``models/pysolver.py``).

The reference's Python users drive training through
``caffe.SGDSolver(prototxt)`` / ``caffe.get_solver(prototxt)``
(python/caffe/_caffe.cpp:259-345 exposes Solver with ``.net``,
``.test_nets``, ``.iter``, ``step(n)``, ``solve()``, ``snapshot()``,
``restore(state)``; python/caffe/__init__.py re-exports the per-type
classes).  This wrapper puts that surface over :class:`GraphSolver`,
which implements the ``Solver::Step`` loop.

``solver.net`` / ``solver.test_nets[i]`` are live VIEWS onto the solver's
parameter trees (test nets are ``ShareTrainedLayersWith`` the train net,
solver.cpp:110-119): a ``forward()`` on a view sees the latest step's
weights, and assigning ``view.params`` writes through.

The solver runs on ``device=`` if given, else the device
``caffe_compat.set_mode_*`` chose, else CUDA (which raises without a
card).  On the card a ``step`` iteration is one CUDA graph replay
(``GraphSolver``), and so is a view's ``forward``: one replay of the
graph of the view and its batch's shapes (the solver's ``forwards``),
reading the solver's static carry in place.  A train-net forward writes
the BN statistics into that carry after the replay, as Forward would.

Differences, by design (as in the JAX package):

* ``view.blobs`` holds every top only after an explicit ``forward()``;
  after ``step(n)`` it carries the train net's OUTPUT blobs of the last
  iteration (still on the device: ``.data`` copies one to the host when
  read).
* ``step(n)`` runs the reference loop INCLUDING test-interval passes and
  snapshots (Solver::Step does both; pycaffe inherits that).
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict

from ..device import pycaffe_device
from ..utils.seed import derive_seed
from ..utils.tree import tree_map
from .pynet import Blob, _as_tensor, _moved, _update_in_place

__all__ = ["Solver", "SGDSolver", "NesterovSolver", "AdaGradSolver",
           "RMSPropSolver", "AdaDeltaSolver", "AdamSolver", "get_solver"]

# seed-derivation tag of a view's forward generator
_VIEW = 0xB10B


class _NetView:
    """pycaffe ``Net`` surface over the owning solver's live trees."""

    def __init__(self, owner: "Solver", net, *, test_id=None):
        self._owner = owner
        self._net = net
        self._test_id = test_id
        self._calls = 0
        self.blobs: OrderedDict = OrderedDict()

    @property
    def _feeds(self):
        # read LIVE off the solver: restore() rebuilds and rebinds the feed
        # lists, and a list captured by value would keep serving batches
        # from the stale pre-restore stream position
        gs = self._owner._gs
        if self._test_id is None:
            return gs._feeds
        return gs._test_feeds[self._test_id]

    # -- live trees --------------------------------------------------------
    def _trees(self):
        gs = self._owner._gs
        if self._test_id is None:
            return gs.params, gs.state
        return gs._shared_test_trees(self._test_id)

    @property
    def params(self):
        return self._trees()[0]

    @params.setter
    def params(self, value):
        gs = self._owner._gs
        if self._test_id is not None:
            raise AttributeError(
                "test nets share the train net's weights "
                "(ShareTrainedLayersWith); assign solver.net.params")
        gs.params = tree_map(lambda x: _as_tensor(x, gs.device), value)

    @property
    def layer_names(self):
        return [n.name for n in self._net.layers]

    @property
    def outputs(self):
        return self._net.output_blob_names()

    # -- forward -----------------------------------------------------------
    def forward(self, **overrides):
        """Pull the next batch from this net's prototxt data feeds (the
        data layer advances, like ``net.forward()`` on a net with a
        DataLayer), optionally override named input blobs, run the net,
        and fill ``self.blobs`` with EVERY top.  Returns {output blob:
        Blob}."""
        gs = self._owner._gs
        batch = dict(gs._host_batch(self._feeds)) if self._feeds else {}
        batch.update({k: _as_tensor(v, gs.device)
                      for k, v in overrides.items()})
        train = self._test_id is None
        self._calls += 1
        gs._static_carry()      # weights assigned since: into the carry
        p, s = self._trees()

        def body(b, generators):
            blobs, new_state = self._net.apply(p, s, b, train=train,
                                               generator=generators[0])
            return blobs, _moved(s, new_state)

        blobs, moved = gs.forwards(
            ("view", self._test_id), body, batch, fixed=(p, s),
            generators=(derive_seed(gs.seed, _VIEW, self._calls),))
        if train:
            _update_in_place(s, moved)      # the BN EMA moves
        self.blobs = OrderedDict((k, Blob(v)) for k, v in blobs.items())
        return OrderedDict((k, self.blobs[k]) for k in self.outputs
                           if k in self.blobs)

    # -- weights IO ---------------------------------------------------------
    def save(self, path: str):
        """``net.save(path)`` (Net::ToProto / ToHDF5 by extension)."""
        from ..utils.caffemodel import (save_caffemodel_binaryproto,
                                        save_caffemodel_h5)

        p, s = self._trees()
        specs = self._net.caffemodel_specs(p, s)
        save = (save_caffemodel_h5 if path.endswith((".h5", ".hdf5"))
                else save_caffemodel_binaryproto)
        return save(path, p, s, specs=specs)

    def copy_from(self, path: str):
        """``net.copy_from(path)`` == solver ``--weights``."""
        if self._test_id is not None:
            raise AttributeError("copy_from through solver.net (test nets "
                                 "share the train net's weights)")
        return self._owner._gs.copy_weights(path)


class Solver:
    """``get_solver("solver.prototxt")``: see the module docstring.

    >>> solver = get_solver("solver.prototxt")
    >>> solver.step(100)
    >>> float(solver.net.blobs["loss"])      # last step's output blob
    >>> solver.net.forward()                 # all tops, next data batch
    >>> solver.test_nets[0].forward()
    >>> solver.snapshot(); solver.restore("snap_iter_100.solverstate")
    """

    _force_type: str | None = None  # subclasses pin the solver algorithm

    def __init__(self, solver: str, *, device=None, **kw):
        # imported here: ``models`` exports this class, and ``training``
        # imports ``models``
        from ..training.graph_solver import GraphSolver
        from ..training.optim import make_solver
        self._gs = GraphSolver(solver, device=pycaffe_device(device), **kw)
        gs = self._gs
        if self._force_type and gs.cfg.solver_type != self._force_type:
            # _caffe.cpp's per-type classes construct that solver type
            # regardless of the prototxt's `type:` field
            gs.cfg = dataclasses.replace(gs.cfg,
                                         solver_type=self._force_type)
            gs.solver = make_solver(gs.cfg, gs.net.param_spec(gs.params))
            gs.opt_state = gs.solver.init(gs.params)
        self.net = _NetView(self, gs.net)
        self.test_nets = [
            _NetView(self, tnet, test_id=i)
            for i, tnet in enumerate(gs.test_nets)]

    @property
    def iter(self) -> int:
        return self._gs.iter_

    @property
    def history(self):
        return self._gs.history

    def _publish_outs(self):
        self.net.blobs.update(
            (k, Blob(v)) for k, v in self._gs.last_outs.items())

    def step(self, iters: int):
        out = self._gs.step(iters)
        self._publish_outs()
        return out

    def solve(self):
        out = self._gs.solve()
        self._publish_outs()
        return out

    def add_callback(self, on_start, on_gradients_ready):
        """Solver::add_callback (solver.hpp:87; pycaffe exposes the same
        pair): ``on_start`` fires at each iteration's start,
        ``on_gradients_ready`` after the step (update included; see
        GraphSolver.callbacks)."""
        self._gs.callbacks.append((on_start, on_gradients_ready))

    def test_nets_forward_all(self):
        """Solver::TestAll: averaged output blobs per test net."""
        return self._gs.test_all()

    def snapshot(self):
        return self._gs.snapshot()

    def restore(self, state_path: str):
        if not os.path.exists(state_path):
            raise FileNotFoundError(state_path)
        return self._gs.restore(state_path)


class SGDSolver(Solver):
    _force_type = "sgd"


class NesterovSolver(Solver):
    _force_type = "nesterov"


class AdaGradSolver(Solver):
    _force_type = "adagrad"


class RMSPropSolver(Solver):
    _force_type = "rmsprop"


class AdaDeltaSolver(Solver):
    _force_type = "adadelta"


class AdamSolver(Solver):
    _force_type = "adam"


def get_solver(path: str, **kw) -> Solver:
    """caffe.get_solver: solver type read from the prototxt
    (SolverRegistry::CreateSolver)."""
    return Solver(path, **kw)
