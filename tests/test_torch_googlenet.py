"""GoogLeNet as BVLC trains it, through the port's ``caffe train`` path
(``GraphSolver`` on the benchmark's solver and net prototxts, the Data
layer reading an LMDB of raw 256 x 256 Datums), held to the plain
reference ``googlenet_reference.py`` at the published widths, batch 2 at
224 x 224: the net's math in float64; the solver's iterations in float32
against the reference's in float64, with and without the port's ReLU and
pooling choices pinned to its float64 run (``_Pinned``).
"""

import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import googlenet_reference as ref
from h100_bench.runners.solver import to_program as _program_layout
from mms_answer_selection_tpu_torch.models.graph_net import GraphNet
from mms_answer_selection_tpu_torch.training.graph_solver import GraphSolver
from mms_answer_selection_tpu_torch.utils.io import array_to_datum
from mms_answer_selection_tpu_torch.utils.lmdb_io import write_lmdb

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "h100_bench" / "configs" / "googlenet"
SEED = 2**31 + 7
ROWS, BATCH = 6, 2
SGD = {"base_lr": 0.01, "power": 0.5, "max_iter": 2400000, "momentum": 0.9,
       "weight_decay": 0.0002}


def _images():
    rng = np.random.default_rng(11)
    pixels = rng.integers(0, 256, (ROWS, 3, ref.SIDE, ref.SIDE), np.uint8)
    return (torch.from_numpy(pixels),
            torch.from_numpy(rng.integers(0, ref.CLASSES, ROWS)))


def _flat(tree):
    return {f"{n}/{k}": v for n, leaf in tree.items() for k, v in leaf.items()}


class _Pinned:
    """The port's ReLU and MAX pooling, with their choices (which inputs
    pass a ReLU, which input wins each pooling window) recorded from a
    float64 run and replayed in a float32 one.  A float32 run rounds each
    blob about 1e-7 away from float64; where a pre-activation lies that
    close to 0, or two inputs of a window that close together, the
    rounding flips the choice and moves a whole element's gradient (on
    these images, about 4e-3 of a leaf's largest gradient element).  With
    the choices pinned, what is left between the runs is rounding."""

    def __init__(self, patch):
        from mms_answer_selection_tpu_torch.models import graph_net
        from mms_answer_selection_tpu_torch.ops import zoo

        self.kept, self.at, self.recording = [], 0, True
        relu, pool = zoo.relu, graph_net.pool2d_padded

        def pinned_relu(x, *, negative_slope=0.0):
            if self.recording:
                self.kept.append(x.detach() > 0)
                return relu(x, negative_slope=negative_slope)
            return torch.where(self._next(), x, negative_slope * x)

        def pinned_pool(x, kh, kw, *, stride_h, stride_w, pad_h=0, pad_w=0,
                        mode="max"):
            y = pool(x, kh, kw, stride_h=stride_h, stride_w=stride_w,
                     pad_h=pad_h, pad_w=pad_w, mode=mode)
            if mode != "max":
                return y
            end_h = (y.shape[1] - 1) * stride_h + kh - x.shape[1] - pad_h
            end_w = (y.shape[2] - 1) * stride_w + kw - x.shape[2] - pad_w
            xc = F.pad(x.permute(0, 3, 1, 2),
                       (pad_w, max(0, end_w), pad_h, max(0, end_h)),
                       value=-math.inf)
            if self.recording:
                self.kept.append(F.max_pool2d(
                    xc.detach(), (kh, kw), (stride_h, stride_w),
                    return_indices=True)[1])
                return y
            idx = self._next()
            return xc.flatten(2).gather(2, idx.flatten(2)).view(
                idx.shape).permute(0, 2, 3, 1)

        patch.setattr(zoo, "relu", pinned_relu)
        patch.setattr(graph_net, "pool2d_padded", pinned_pool)

    def _next(self):
        self.at += 1
        return self.kept[self.at - 1]


def _lmdb_solver(tmp):
    pixels, labels = _images()
    write_lmdb(str(tmp / "ilsvrc12_train_lmdb"),
               ((b"%08d" % i, array_to_datum(pixels[i].numpy(),
                                             int(labels[i])))
                for i in range(ROWS)))
    text = (CONFIG / "train_val.prototxt").read_text()
    assert text.count("batch_size: 32\n") == 1
    (tmp / "train_val.prototxt").write_text(
        text.replace("batch_size: 32\n", f"batch_size: {BATCH}\n"))
    shutil.copy(CONFIG / "solver.prototxt", tmp / "solver.prototxt")
    return GraphSolver(str(tmp / "solver.prototxt"), device="cpu", seed=SEED)


def _solve(gs, params):
    """Two iterations of ``gs`` from ``params``: the losses, SGD's
    history after the first, the weights before and after it."""
    gs.params = _program_layout(params)
    p0 = {k: v.clone() for k, v in _flat(gs.params).items()}
    losses = [gs.step(1)]
    history = {k: v.clone() for k, v in _flat(gs.opt_state["h"]).items()}
    after = {k: v.clone() for k, v in _flat(gs.params).items()}
    losses.append(gs.step(1))
    return {"losses": losses, "history": history, "p0": p0, "after": after}


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """Two float32 iterations of GraphSolver from the reference's weights,
    its ReLU and pooling choices pinned to the port's float64 net on the
    reference's float64 iterations (``_Pinned``), and those float64
    iterations of the reference."""
    torch.set_num_threads(4)
    pixels, labels = _images()
    init = ref.init(SEED, "cpu")
    wide = {n: {k: v.double() for k, v in leaf.items()}
            for n, leaf in init.items()}
    want = ref.train(pixels, labels, SEED, SGD, BATCH, 2, "cpu",
                     params=wide, dtype=torch.float64)
    once = ref.train(pixels, labels, SEED, SGD, BATCH, 1, "cpu",
                     params=wide, dtype=torch.float64)
    net = GraphNet((CONFIG / "train_val.prototxt").read_text(),
                   phase="train")
    plan = ref.crops(SEED, 2 * BATCH, ROWS)
    gs = _lmdb_solver(tmp_path_factory.mktemp("googlenet"))
    with pytest.MonkeyPatch.context() as patch:
        pins = _Pinned(patch)
        with torch.no_grad():
            for it, weights in enumerate((wide, _unflat(once["params"]))):
                rows = plan[it * BATCH:(it + 1) * BATCH]
                x = ref.batch(pixels, rows, "cpu").double()
                gen = torch.Generator().manual_seed(
                    ref.step_seed(SEED, it, 0))
                net.loss(_program_layout(weights), {},
                         {"data": x.permute(0, 2, 3, 1),
                          "label": labels[torch.as_tensor(rows[:, 0])]},
                         generator=gen)
        pins.recording = False
        out = _solve(gs, init)
        assert pins.at == len(pins.kept)         # every choice replayed
    out.update(ref=want,
               mine=_flat(_program_layout(_unflat(once["params"]))))
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        layer, leaf = key.rsplit("/", 1)
        tree.setdefault(layer, {})[leaf] = v
    return tree


def test_the_net_is_the_reference_in_float64():
    """One forward and backward of the port's GraphNet on the benchmark's
    net, the reference's batch and dropout masks, in float64: the same
    loss and every leaf's gradient, to rounding."""
    torch.set_num_threads(4)
    pixels, labels = _images()
    plan = ref.crops(SEED, BATCH, ROWS)
    x = ref.batch(pixels, plan, "cpu").double()
    y = labels[torch.as_tensor(plan[:, 0])]
    init = {n: {k: v.double() for k, v in leaf.items()}
            for n, leaf in ref.init(SEED, "cpu").items()}
    net = GraphNet((CONFIG / "train_val.prototxt").read_text(),
                   phase="train")
    params = {n: {k: v.requires_grad_(True) for k, v in leaf.items()}
              for n, leaf in _program_layout(init).items()}
    gen = torch.Generator().manual_seed(ref.step_seed(SEED, 0, 0))
    loss, _ = net.loss(params, {}, {"data": x.permute(0, 2, 3, 1), "label": y},
                       generator=gen)
    leaves = _flat(params)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    tree = {n: {k: v.requires_grad_(True) for k, v in leaf.items()}
            for n, leaf in init.items()}
    gen = torch.Generator().manual_seed(ref.step_seed(SEED, 0, 0))
    masks = [torch.rand((BATCH, 1024), generator=gen,
                        dtype=torch.float32) for _ in ref.DROPOUT]
    want_loss = ref.loss(ref.forward(tree, x, masks), y)
    flat = _flat(tree)
    want = dict(zip(flat, torch.autograd.grad(want_loss,
                                              list(flat.values()))))
    want = _flat(_program_layout(_unflat(want)))
    # the port sums its loss tops in float32 (GraphNet.loss)
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    assert abs(loss - want_loss) <= 1e-7 * want_loss
    assert got.keys() == want.keys() and len(got) == 2 * 64
    for k in want:
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= 1e-6 * scale, k


def _gradient_gap(run):
    """The largest gap of the first gradient, read from SGD's history
    after iteration 0 (h = base_lr lr_mult (g + wd decay_mult w0)), from
    the reference's float64 gradient, over each leaf's largest element."""
    want = _flat(_program_layout(_unflat(run["ref"]["grads"])))
    gaps = {}
    for k, h in run["history"].items():
        lr_mult, decay_mult = ref.MULTS[k.rsplit("/", 1)[1]]
        g = h.double() / (SGD["base_lr"] * lr_mult)
        if decay_mult:
            g = g - SGD["weight_decay"] * decay_mult * run["p0"][k].double()
        gaps[k] = float((g - want[k]).abs().max() / want[k].abs().max())
    assert gaps.keys() == want.keys()
    return max(gaps.values())


def test_solver_losses_follow_the_reference(solved):
    """Both iterations' losses, the second after one update: float32's
    rounding alone (1e-7 here), where a skipped update, a wrong rate or
    another batch moves the loss by tenths."""
    want = solved["ref"]["losses"]
    for got, loss in zip(solved["losses"], want):
        assert abs(got - loss) <= 1e-6 * loss


def test_solver_first_gradient_is_the_references(solved):
    """Each leaf of the first gradient within 1e-5 of its own largest
    element (2e-6 here)."""
    assert _gradient_gap(solved) <= 1e-5


def test_solver_parameters_after_the_first_iteration(solved):
    """Each leaf after the first update within 5e-4 of the reference's
    move (6e-5 here: the rounding of the float32 weights the move is
    added to); a wrong rate, momentum, decay or multiplier moves a leaf by
    its whole step."""
    mine, want = solved["after"], solved["mine"]
    for k in want:
        moved = float((want[k] - solved["p0"][k]).abs().max())
        assert float((mine[k] - want[k]).abs().max()) <= 5e-4 * moved, k


def test_solver_unpinned_parts_by_the_flipped_choices(solved, tmp_path):
    """GraphSolver as it runs, its choices free: the first loss to
    rounding; the first gradient within a hundredth of each leaf's
    largest element (4.3e-3 here, all of it the flips of ``_Pinned``:
    the port's float32 convolutions over NHWC batches round otherwise than
    the reference's over NCHW ones); the second loss within 1e-3 (1.1e-4
    here), the flips' gradient moved by one update."""
    run = _solve(_lmdb_solver(tmp_path), ref.init(SEED, "cpu"))
    want = solved["ref"]["losses"]
    assert abs(run["losses"][0] - want[0]) <= 1e-6 * want[0]
    assert abs(run["losses"][1] - want[1]) <= 1e-3 * want[1]
    assert _gradient_gap(dict(run, ref=solved["ref"])) <= 1e-2


def test_structure_widths_losses_and_work():
    from h100_bench import convnet_flops

    text = (CONFIG / "train_val.prototxt").read_text()
    net = GraphNet(text, phase="train")
    concats = [n for n in net.layers if n.type == "Concat"]
    count = convnet_flops.forward_macs(text)
    assert [count["blobs"][n.tops[0]][0] for n in concats] == \
        [256, 480, 512, 512, 512, 528, 832, 832, 1024]
    assert net.blob_loss_weights() == {"loss1/loss1": 0.3,
                                       "loss2/loss1": 0.3,
                                       "loss3/loss3": 1.0}
    assert sum(n.type == "Convolution" for n in net.layers) == 59
    assert count["total"] == 1_591_044_096
    aux = sum(v for k, v in count["by_layer"].items()
              if k.startswith(("loss1/", "loss2/")))
    assert count["total"] - aux == 1_582_671_872
    assert convnet_flops.train_flops(text) * 32 == pytest.approx(3.0548e11,
                                                                  rel=1e-4)
    # the test phase adds the accuracy layers and the other data source
    test = GraphNet(text, phase="test")
    assert sum(n.type == "Accuracy" for n in test.layers) == 6


def test_the_reference_copies_are_one_file():
    assert (ROOT / "tests" / "googlenet_reference.py").read_bytes() == \
        (ROOT / "h100_bench" / "reference" / "googlenet.py").read_bytes()
