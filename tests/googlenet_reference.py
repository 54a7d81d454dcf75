"""GoogLeNet as BVLC Caffe trains it, in plain float32 PyTorch: the
reference that a ``caffe train`` of the benchmark's GoogLeNet is held to.

Written from Szegedy et al., "Going Deeper with Convolutions"
(arXiv:1409.4842), Table 1, with the auxiliary heads, fillers and solver
of BVLC Caffe's ``models/bvlc_googlenet`` (``train_val.prototxt``,
``quick_solver.prototxt``).  It reads no prototxt and imports nothing but
numpy and torch: NCHW tensors, ``F.conv2d``, TF32 off unless asked for.

What it gives, from the seed and the training images' bytes:

* ``init``: the weights in Caffe's blob layout (convolutions (O, I, kh,
  kw), inner products (out, in) with ``in`` in (C, H, W) order): xavier,
  uniform in +-sqrt(3 / fan_in) as Caffe's ``XavierFiller`` draws it, the
  convolutions' and the auxiliary fc layers' biases 0.2, the three
  classifiers' biases 0;
* ``crops``: the Data layer's transform as a solver's feed draws it: a
  ``numpy`` generator seeded with the solver's seed, and for each image
  in turn (key order, wrapping at the end) the row offset, then the
  column offset, uniform in [0, 256 - 224], then the mirror flag, a
  uniform draw below 0.5;
* ``train``: ``iters`` SGD iterations: forward (the three heads), the
  weighted loss 0.3 loss1 + 0.3 loss2 + loss3, its gradients by autograd,
  and the update h = m h + rate lr_mult (g + wd decay_mult w), w -= h,
  with rate = base_lr (1 - it / max_iter) ^ power (``poly``).  The
  dropout masks of iteration ``it`` are drawn from a generator on the
  device seeded with ``step_seed(seed, it, 0)``, in the net's layer order
  (loss1/drop_fc, loss2/drop_fc, pool5/drop_7x7_s1), each a uniform draw
  of the layer's batch x 1024 elements kept below 1 - ratio.

Departures from the paper and from BVLC's files, each deliberate:

* The weights are drawn here from the run's seed, not by the solver's own
  fillers; the benchmark hands the same weights to the program.
* Pooling sizes use Caffe's ceil rule, written out as trailing pads
  (``_pool``); at 224 x 224 every window lies inside its input, so the
  counts of AVE pooling are whole windows.
* LRN is Caffe's ACROSS_CHANNELS form, k = 1, alpha divided by the
  window size (the paper names only "local response normalization").
* Only the TRAIN phase is written: no TEST data layer, no Accuracy.
* BVLC's xavier fillers carry a ``std`` that Caffe's XavierFiller
  ignores; it is left out.
* The loss is the sum of the three heads' weighted means, as Caffe's
  net sums its loss tops, each sample's capped at -log FLT_MIN as
  Caffe's SoftmaxWithLoss caps it; the paper gives the 0.3 weight alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# the stream tag of the initial weights' draws
WEIGHTS = 3
# the tag of the solver's per-iteration generators (``step_seed``)
STEP = 0x5EED

CROP, SIDE = 224, 256
MEAN = (104.0, 117.0, 123.0)            # B, G, R: mean_value, as BVLC's
CLASSES = 1000
AUX_WEIGHT = 0.3
# Table 1: #1x1; #3x3 reduce, #3x3; #5x5 reduce, #5x5; pool proj
INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}
# (lr_mult, decay_mult) of each layer's weights and biases
MULTS = {"w": (1.0, 1.0), "b": (2.0, 0.0)}
DROPOUT = {"loss1/drop_fc": 0.7, "loss2/drop_fc": 0.7,
           "pool5/drop_7x7_s1": 0.4}
# each inner product's input as (C, H, W)
FC_IN = {"loss1/fc": (128, 4, 4), "loss1/classifier": (1024, 1, 1),
         "loss2/fc": (128, 4, 4), "loss2/classifier": (1024, 1, 1),
         "loss3/classifier": (1024, 1, 1)}


def seed_of(*ints: int) -> int:
    """A 63-bit seed that is a fixed function of ``ints``."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def step_seed(seed: int, it: int, i: int) -> int:
    """The seed of micro-batch ``i``'s dropout generator at ``it``."""
    return seed_of(seed, STEP, it, i)


# ---------------------------------------------------------------- the net
def layers() -> list:
    """(name, kind, shape) of every layer with weights, in the net's
    order: ("conv", (out, in, k, stride, pad)) or ("fc", (out, in))."""
    out = [("conv1/7x7_s2", "conv", (64, 3, 7, 2, 3)),
           ("conv2/3x3_reduce", "conv", (64, 64, 1, 1, 0)),
           ("conv2/3x3", "conv", (192, 64, 3, 1, 1))]
    c = 192
    for tag, (c1, r3, c3, r5, c5, pp) in INCEPTION.items():
        p = f"inception_{tag}"
        out += [(f"{p}/1x1", "conv", (c1, c, 1, 1, 0)),
                (f"{p}/3x3_reduce", "conv", (r3, c, 1, 1, 0)),
                (f"{p}/3x3", "conv", (c3, r3, 3, 1, 1)),
                (f"{p}/5x5_reduce", "conv", (r5, c, 1, 1, 0)),
                (f"{p}/5x5", "conv", (c5, r5, 5, 1, 2)),
                (f"{p}/pool_proj", "conv", (pp, c, 1, 1, 0))]
        c = c1 + c3 + c5 + pp
        if tag in ("4a", "4d"):
            h = "loss1" if tag == "4a" else "loss2"
            out += [(f"{h}/conv", "conv", (128, c, 1, 1, 0)),
                    (f"{h}/fc", "fc", (1024, 128 * 4 * 4)),
                    (f"{h}/classifier", "fc", (CLASSES, 1024))]
    out.append(("loss3/classifier", "fc", (CLASSES, 1024)))
    return out


def init(seed: int, device) -> dict:
    """{layer: {"w", "b"}} in Caffe's layout, drawn in layer order from a
    generator on ``device`` seeded from (seed, ``WEIGHTS``)."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, WEIGHTS))
    params = {}
    for name, kind, shape in layers():
        if kind == "conv":
            o, i, k = shape[:3]
            wshape, fan_in = (o, i, k, k), i * k * k
        else:
            wshape, fan_in = shape, shape[1]
        s = (3.0 / fan_in) ** 0.5
        w = torch.rand(wshape, generator=gen, device=device) * (2 * s) - s
        bias = 0.0 if name.endswith("classifier") else 0.2
        params[name] = {"w": w, "b": torch.full((wshape[0],), bias,
                                                device=device)}
    return params


def _conv(p, x, stride=1, pad=0):
    return F.relu(F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad))


def _fc(p, x):
    return x.flatten(1) @ p["w"].t() + p["b"]


def _pool(x, k, s, pad=0, mode="max"):
    """Caffe's pooling: pooled = ceil((H + 2 pad - k) / s) + 1, the grid
    covered by trailing pads (-inf for MAX); AVE divides by whole
    windows, which every window here is."""
    h = x.shape[2]
    pooled = -(-(h + 2 * pad - k) // s) + 1
    if pad and (pooled - 1) * s >= h + pad:
        pooled -= 1
    extra = max(0, (pooled - 1) * s + k - h - 2 * pad)
    if mode == "max":
        x = F.pad(x, (pad, pad + extra, pad, pad + extra),
                  value=-float("inf"))
        return F.max_pool2d(x, k, s)
    if pad or extra:
        raise ValueError("AVE pooling here has no partial window")
    return F.avg_pool2d(x, k, s)


def _lrn(x, size=5, alpha=1e-4, beta=0.75, k=1.0):
    """ACROSS_CHANNELS: x / (k + alpha / size * sum of x^2 over the
    ``size`` channels centred on each)^beta."""
    c, half = x.shape[1], size // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    window = sum(sq[:, i:i + c] for i in range(size))
    return x / (k + (alpha / size) * window) ** beta


def _dropout(x, u, ratio):
    keep = 1.0 - ratio
    return torch.where(u.view_as(x) < keep, x / keep, torch.zeros_like(x))


def _inception(params, tag, x, zero=None):
    p = f"inception_{tag}"
    b1 = _conv(params[f"{p}/1x1"], x)
    b3 = _conv(params[f"{p}/3x3"], _conv(params[f"{p}/3x3_reduce"], x),
               pad=1)
    b5 = _conv(params[f"{p}/5x5"], _conv(params[f"{p}/5x5_reduce"], x),
               pad=2)
    bp = _conv(params[f"{p}/pool_proj"], _pool(x, 3, 1, pad=1))
    if zero == f"{p}/pool_proj":
        bp = torch.zeros_like(bp)
    return torch.cat([b1, b3, b5, bp], dim=1)


def _aux(params, h, x, u):
    x = _conv(params[f"{h}/conv"], _pool(x, 5, 3, mode="ave"))
    x = F.relu(_fc(params[f"{h}/fc"], x))
    x = _dropout(x, u, DROPOUT[f"{h}/drop_fc"])
    return _fc(params[f"{h}/classifier"], x)


def forward(params, x, masks, zero=None):
    """(N, 3, 224, 224) mean-subtracted images -> the three heads' logits
    (loss1, loss2, loss3); ``masks``: the three dropout draws in layer
    order; ``zero``: a branch whose output is replaced by zeros (a
    planted fault)."""
    x = _conv(params["conv1/7x7_s2"], x, stride=2, pad=3)
    x = _lrn(_pool(x, 3, 2))
    x = _conv(params["conv2/3x3_reduce"], x)
    x = _conv(params["conv2/3x3"], x, pad=1)
    x = _pool(_lrn(x), 3, 2)
    x = _inception(params, "3a", x, zero)
    x = _inception(params, "3b", x, zero)
    x = _pool(x, 3, 2)
    x = _inception(params, "4a", x, zero)
    out1 = _aux(params, "loss1", x, masks[0])
    for tag in ("4b", "4c", "4d"):
        x = _inception(params, tag, x, zero)
    out2 = _aux(params, "loss2", x, masks[1])
    x = _inception(params, "4e", x, zero)
    x = _pool(x, 3, 2)
    x = _inception(params, "5a", x, zero)
    x = _inception(params, "5b", x, zero)
    x = _pool(x, 7, 1, mode="ave")
    x = _dropout(x, masks[2], DROPOUT["pool5/drop_7x7_s1"])
    return out1, out2, _fc(params["loss3/classifier"], x)


def _softmax_loss(logits, labels):
    """Caffe's SoftmaxWithLoss: the batch's mean of -log max(p, FLT_MIN),
    each sample's loss at most -log FLT_MIN = 87.34; its gradient is
    p - onehot whatever the cap (the backward takes no cap)."""
    per = -F.log_softmax(logits, dim=1).gather(1, labels[:, None])[:, 0]
    cap = -float(np.log(np.finfo(np.float32).tiny))
    return (per - (per - per.clamp(max=cap)).detach()).mean()


def loss(logits, labels):
    """0.3 loss1 + 0.3 loss2 + loss3, each Caffe's softmax loss."""
    l1, l2, l3 = (_softmax_loss(z, labels) for z in logits)
    return AUX_WEIGHT * l1 + AUX_WEIGHT * l2 + l3


# ---------------------------------------------------------------- the feed
def crops(seed: int, count: int, rows: int) -> np.ndarray:
    """(count, 4) int64: for each of the feed's first ``count`` images,
    its row in the database (key order, wrapping), its row and column
    offsets and its mirror flag, drawn as the solver's feed draws them
    from ``seed``."""
    rng = np.random.default_rng(seed)
    out = np.empty((count, 4), np.int64)
    for n in range(count):
        y = int(rng.integers(0, SIDE - CROP + 1))
        x = int(rng.integers(0, SIDE - CROP + 1))
        out[n] = (n % rows, y, x, int(rng.random() < 0.5))
    return out


def batch(images: torch.Tensor, plan: np.ndarray, device) -> torch.Tensor:
    """The batch of ``plan``'s rows: ``images`` (rows, 3, 256, 256) uint8
    in Datum order (B, G, R), cropped, mirrored, less the mean, as
    float32 NCHW on ``device``."""
    out = []
    for row, y, x, flip in plan.tolist():
        img = images[row, :, y:y + CROP, x:x + CROP].to(torch.float32)
        out.append(img.flip(-1) if flip else img)
    mean = torch.tensor(MEAN).view(1, 3, 1, 1)
    return (torch.stack(out) - mean).to(device)


# ---------------------------------------------------------------- training
def _flat(params) -> dict:
    return {f"{n}/{k}": v for n, leaf in params.items()
            for k, v in leaf.items()}


def learning_rate(solver: dict, it: int) -> float:
    """``poly``: base_lr (1 - it / max_iter) ^ power."""
    return solver["base_lr"] * (1.0 - it / solver["max_iter"]) \
        ** solver["power"]


def train(images, labels, seed: int, solver: dict, batch_size: int,
          iters: int, device, *, params=None, tf32: bool = False,
          keep: int | None = None, zero: str | None = None,
          frozen: bool = False, dtype=torch.float32) -> dict:
    """``iters`` SGD iterations from ``params`` (default ``init(seed)``)
    on the feed of ``images`` / ``labels`` (uint8 (rows, 3, 256, 256),
    int64 (rows,), on the host).  Returns {"losses": [float], "grads":
    the first iteration's gradient, "params": after the iterations,
    "init": before}, the trees flat as {"layer/w": tensor}.  ``dtype``:
    the images' precision, float64 with float64 ``params`` for a run
    without float32's rounding.

    Controls and planted faults: ``tf32`` runs the products in TF32;
    ``keep`` trains each batch's first ``keep`` rows alone; ``zero``
    replaces a branch's output by zeros; ``frozen`` leaves the state
    unchanged (no update, no history)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        params = init(seed, device) if params is None else {
            n: dict(leaf) for n, leaf in params.items()}
        start = {k: v.clone() for k, v in _flat(params).items()}
        history = {k: torch.zeros_like(v) for k, v in start.items()}
        plan = crops(seed, iters * batch_size, images.shape[0])
        losses, first = [], None
        for it in range(iters):
            rows = plan[it * batch_size:(it + 1) * batch_size]
            n = batch_size if keep is None else keep
            x = batch(images, rows[:n], device).to(dtype)
            y = labels[torch.as_tensor(rows[:n, 0])].to(device)
            gen = torch.Generator(device=device).manual_seed(
                step_seed(seed, it, 0))
            masks = [torch.rand((n, 1024), generator=gen, device=device,
                                dtype=torch.float32) for _ in DROPOUT]
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in _flat(params).items()}
            tree = {}
            for key, v in leaves.items():
                layer, leaf = key.rsplit("/", 1)
                tree.setdefault(layer, {})[leaf] = v
            total = loss(forward(tree, x, masks, zero), y)
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(leaves.items(), grads)}
            losses.append(float(total.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            if frozen:
                continue
            rate = learning_rate(solver, it)
            with torch.no_grad():
                for key, g in grads.items():
                    lr_mult, decay_mult = MULTS[key.rsplit("/", 1)[1]]
                    p = leaves[key].detach()
                    step = g + (solver["weight_decay"] * decay_mult) * p \
                        if decay_mult else g
                    history[key] = solver["momentum"] * history[key] \
                        + (rate * lr_mult) * step
                    layer, leaf = key.rsplit("/", 1)
                    params[layer][leaf] = p - history[key]
        return {"losses": losses, "grads": first, "init": start,
                "params": {k: v.detach().clone()
                           for k, v in _flat(params).items()},
                "history": history}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
