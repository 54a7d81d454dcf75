"""Text-prototxt ingestion (counterpart of ``utils/prototxt.py``, whose
body is free of JAX: its code is kept here unchanged): reference solver
configs -> our typed configs.

The reference configures everything through protobuf text files; the QA
QA script writes its `solver.prototxt` via `str(SolverParameter())`
(do_trec_qa_clean.py:322-348).  Migrating users carry those files, so
`qa train --solver-prototxt solver.prototxt` consumes them directly:
a small generic text-proto parser (the subset protobuf's text format
actually uses: `key: value` scalars, `key { ... }` nested messages,
repeated fields, '#' comments) plus a field map onto SolverConfig /
TrainerConfig (SolverParameter fields, caffe.proto:102-242; legacy enum
`solver_type: ADADELTA` and the modern `type: "AdaDelta"` both accepted,
upgrade_proto.cpp:937-1044's job).
"""

from __future__ import annotations

import re

_TOKEN = re.compile(r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<brace_open>\{)
      | (?P<brace_close>\})
      | (?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*(?P<colon>:)?
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<scalar>[^\s{}#]+)
    )""", re.VERBOSE)


def parse_prototxt(text: str) -> dict:
    """Protobuf text format -> nested dict; repeated fields -> lists."""
    pos = 0
    stack = [{}]
    pending_key = None
    n = len(text)

    def store(key, value):
        d = stack[-1]
        if key in d:
            if not isinstance(d[key], list):
                d[key] = [d[key]]
            d[key].append(value)
        else:
            d[key] = value

    while pos < n:
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip() == "":
                break
            raise ValueError(f"prototxt parse error at {text[pos:pos+40]!r}")
        pos = m.end()
        if m.group("comment"):
            continue
        if m.group("brace_open"):
            if pending_key is None:
                raise ValueError("'{' without a field name")
            child: dict = {}
            store(pending_key, child)
            stack.append(child)
            pending_key = None
        elif m.group("brace_close"):
            if len(stack) == 1:
                raise ValueError("unbalanced '}'")
            stack.pop()
        elif m.group("key") is not None:
            if pending_key is not None and not m.group("colon"):
                # bare identifier value: a bool or an enum (TRAIN, ADADELTA)
                word = m.group("key")
                store(pending_key,
                      {"true": True, "false": False}.get(word, word))
                pending_key = None
            else:
                pending_key = m.group("key")
        elif m.group("string") is not None:
            s = m.group("string")[1:-1]
            s = s.encode().decode("unicode_escape")
            store(pending_key, s)
            pending_key = None
        elif m.group("scalar") is not None:
            raw = m.group("scalar")
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw)
                except ValueError:
                    value = {"true": True, "false": False}.get(raw, raw)
            store(pending_key, value)
            pending_key = None
    if len(stack) != 1:
        raise ValueError("unbalanced '{'")
    return stack[0]


# legacy SolverType enum (caffe.proto SolverParameter.SolverType) -> type
_LEGACY_TYPES = {"SGD": "sgd", "NESTEROV": "nesterov", "ADAGRAD": "adagrad",
                 "RMSPROP": "rmsprop", "ADADELTA": "adadelta",
                 "ADAM": "adam"}


# ---------------------------------------------------------------------------
# legacy NetParameter auto-upgrade (util/upgrade_proto.cpp's structural
# job): V1 nets use `layers:` lists with ENUM types and flat blobs_lr/
# weight_decay multipliers; V0 nets additionally nest every knob inside an
# inner `layer { }` message with lowercase string types.  The reference
# upgrades two generations on every load (NetNeedsV0ToV1Upgrade /
# NetNeedsV1ToV2Upgrade); so do we, before any config recovery.
# ---------------------------------------------------------------------------

# V1LayerParameter.LayerType enum -> modern string (UpgradeV1LayerType,
# upgrade_proto.cpp:937-1044)
_V1_TYPE_NAMES = {
    "ABSVAL": "AbsVal", "ACCURACY": "Accuracy", "ARGMAX": "ArgMax",
    "BNLL": "BNLL", "CONCAT": "Concat",
    "CONTRASTIVE_LOSS": "ContrastiveLoss", "CONVOLUTION": "Convolution",
    "DATA": "Data", "DECONVOLUTION": "Deconvolution", "DROPOUT": "Dropout",
    "DUMMY_DATA": "DummyData", "EUCLIDEAN_LOSS": "EuclideanLoss",
    "ELTWISE": "Eltwise", "EXP": "Exp", "FLATTEN": "Flatten",
    "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss", "IM2COL": "Im2col",
    "IMAGE_DATA": "ImageData", "INFOGAIN_LOSS": "InfogainLoss",
    "INNER_PRODUCT": "InnerProduct", "LRN": "LRN",
    "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss", "MVN": "MVN",
    "POOLING": "Pooling", "POWER": "Power", "RELU": "ReLU",
    "SIGMOID": "Sigmoid",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "SPLIT": "Split", "SLICE": "Slice",
    "TANH": "TanH", "WINDOW_DATA": "WindowData", "THRESHOLD": "Threshold",
}

# V0 string types -> modern (UpgradeV0LayerType, upgrade_proto.cpp:582-660)
_V0_TYPE_NAMES = {
    "accuracy": "Accuracy", "bnll": "BNLL", "concat": "Concat",
    "conv": "Convolution", "data": "Data", "dropout": "Dropout",
    "euclidean_loss": "EuclideanLoss", "flatten": "Flatten",
    "hdf5_data": "HDF5Data", "hdf5_output": "HDF5Output",
    "im2col": "Im2col", "images": "ImageData",
    "infogain_loss": "InfogainLoss", "innerproduct": "InnerProduct",
    "lrn": "LRN", "multinomial_logistic_loss": "MultinomialLogisticLoss",
    "pool": "Pooling", "relu": "ReLU", "sigmoid": "Sigmoid",
    "softmax": "Softmax", "softmax_loss": "SoftmaxWithLoss",
    "split": "Split", "tanh": "TanH", "window_data": "WindowData",
}


def _one_last(v, default=None):
    """Last value of a possibly-repeated scalar field (proto text:
    later occurrences of an optional field overwrite earlier ones)."""
    if isinstance(v, list):
        return v[-1]
    return default if v is None else v


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _param_specs_from_mults(nl, lrs, wds, names=(), shares=()):
    """blobs_lr / weight_decay repeated multipliers (+ V1 ``param``
    share NAMES and ``blob_share_mode``) -> modern param {} specs
    (UpgradeV1LayerParameter, upgrade_proto.cpp:706-735; omitted
    entries read as the proto default 1)."""
    n = max(len(lrs), len(wds), len(names), len(shares))
    if n:
        specs = []
        for i in range(n):
            sp: dict = {}
            if i < len(names):
                sp["name"] = names[i]
            if i < len(shares):
                sp["share_mode"] = shares[i]
            sp["lr_mult"] = lrs[i] if i < len(lrs) else 1.0
            sp["decay_mult"] = wds[i] if i < len(wds) else 1.0
            specs.append(sp)
        nl["param"] = specs


def _upgrade_v1_layer(layer: dict) -> dict:
    nl = {k: v for k, v in layer.items()
          if k not in ("type", "blobs_lr", "weight_decay", "param",
                       "blob_share_mode")}
    t = str(layer.get("type", ""))
    nl["type"] = _V1_TYPE_NAMES.get(t.upper(), t)
    _param_specs_from_mults(nl, _as_list(layer.get("blobs_lr")),
                            _as_list(layer.get("weight_decay")),
                            _as_list(layer.get("param")),
                            _as_list(layer.get("blob_share_mode")))
    return nl


# V0 flat field -> (modern sub-message key per layer type, modern name)
# (UpgradeV0LayerParameter, upgrade_proto.cpp:87-560)
_V0_RENAMES = {"kernelsize": "kernel_size", "biasterm": "bias_term",
               "batchsize": "batch_size", "cropsize": "crop_size",
               "meanfile": "mean_file"}
_V0_PARAM_MSG = {
    "Convolution": "convolution_param",
    "InnerProduct": "inner_product_param",
    "Pooling": "pooling_param",
    "Dropout": "dropout_param",
    "LRN": "lrn_param",
    "Data": "data_param",
    "HDF5Data": "hdf5_data_param",
    "ImageData": "image_data_param",
    "WindowData": "window_data_param",
    "Concat": "concat_param",
    "InfogainLoss": "infogain_loss_param",
}
_V0_KNOBS = ("num_output", "biasterm", "weight_filler", "bias_filler",
             "pad", "kernelsize", "group", "stride", "pool",
             "dropout_ratio", "local_size", "alpha", "beta", "k", "source",
             "scale", "meanfile", "batchsize", "cropsize", "mirror",
             "rand_skip", "shuffle", "new_height", "new_width", "concat_dim")


def _upgrade_v0_layer(outer: dict) -> dict:
    v0 = outer.get("layer", {})
    if isinstance(v0, list):
        v0 = v0[-1]
    t0 = str(v0.get("type", ""))
    t = _V0_TYPE_NAMES.get(t0, t0)
    nl = {"name": v0.get("name", ""), "type": t}
    for key in ("bottom", "top", "include", "exclude"):
        if key in outer:
            nl[key] = outer[key]
    msg = _V0_PARAM_MSG.get(t)
    knobs = {}
    for f in _V0_KNOBS:
        if f in v0:
            knobs[_V0_RENAMES.get(f, f)] = v0[f]
    if msg and knobs:
        nl[msg] = knobs
    if "blobs" in v0:  # binary upgrades carry the weight blobs verbatim
        nl["blobs"] = v0["blobs"]
    _param_specs_from_mults(nl, _as_list(v0.get("blobs_lr")),
                            _as_list(v0.get("weight_decay")))
    return nl


def upgrade_net_prototxt(d: dict) -> dict:
    """Parsed-NetParameter dict -> modern shape.  No-op for modern nets;
    a `layers:` list triggers the V1 (or, when entries nest an inner
    `layer {}`, V0) upgrade."""
    if "layers" not in d:
        return d
    layers = d["layers"]
    if isinstance(layers, dict):
        layers = [layers]
    upgraded = [(_upgrade_v0_layer(la) if "layer" in la
                 else _upgrade_v1_layer(la)) for la in layers]
    out = {k: v for k, v in d.items() if k != "layers"}
    out["layer"] = upgraded
    return out


# solver_type enum value -> the modern string `type:`
# (upgrade_proto.cpp:1002-1035 UpgradeSolverType's exact case strings)
_SOLVER_TYPE_STRINGS = {
    "SGD": "SGD", "NESTEROV": "Nesterov", "ADAGRAD": "AdaGrad",
    "RMSPROP": "RMSProp", "ADADELTA": "AdaDelta", "ADAM": "Adam",
    0: "SGD", 1: "Nesterov", 2: "AdaGrad", 3: "RMSProp", 4: "AdaDelta",
    5: "Adam",
}


def upgrade_solver_prototxt(d: dict) -> dict:
    """Parsed-SolverParameter dict -> modern shape: the legacy
    ``solver_type:`` enum becomes the string ``type:`` field
    (UpgradeSolverType, upgrade_proto.cpp:1002-1035).  No-op when
    already modern; both-fields-present is the same hard error the
    reference CHECKs."""
    if "solver_type" not in d:
        return d
    if "type" in d:
        raise ValueError(
            "old solver_type field (enum) and new type field (string) "
            "cannot be both specified in solver proto text")
    st = d["solver_type"]
    if isinstance(st, list):
        st = st[-1]
    key = st.upper() if isinstance(st, str) else int(st)
    if key not in _SOLVER_TYPE_STRINGS:
        raise ValueError(f"unknown SolverParameter solver_type: {st}")
    out = {k: v for k, v in d.items() if k != "solver_type"}
    out["type"] = _SOLVER_TYPE_STRINGS[key]
    return out


# Fields whose values are PROTO ENUMS (emitted as bare all-caps tokens);
# every other string field is quoted.  Covers the enum fields of
# caffe.proto's NetParameter/LayerParameter/SolverParameter subtree this
# framework ingests (phase/pool/eltwise op/loss norm/db backend/...).
_ENUM_FIELDS = frozenset({
    "phase", "pool", "norm_region", "operation", "snapshot_format",
    "solver_mode", "solver_type", "backend", "engine", "mode", "norm",
    "round_mode", "variance_norm", "db", "level", "share_mode",
    "normalization",  # LossParameter.NormalizationMode
})

_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\t": "\\t",
            "\r": "\\r"}


class EnumToken(str):
    """An explicitly-marked enum token: serialized into prototxt without
    quotes regardless of field name (the NetSpec DSL's ``Enum``)."""


def _emit_value(key: str, v) -> str:
    if isinstance(v, EnumToken):
        return str(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    s = str(v)
    if key in _ENUM_FIELDS and re.fullmatch(r"[A-Z][A-Z0-9_]*", s):
        return s  # enum token, bare
    return '"' + "".join(_ESCAPES.get(c, c) for c in s) + '"'


def emit_prototxt(d: dict, *, indent: int = 0) -> str:
    """Nested dict (the parse_prototxt representation) -> protobuf text
    format.  The inverse of :func:`parse_prototxt` up to formatting:
    ``parse(emit(parse(text))) == parse(text)``.  Backs the `qa upgrade`
    tool (tools/upgrade_net_proto_text.cpp, upgrade_solver_proto_text.cpp
    write the upgraded message back as text the same way)."""
    pad = "  " * indent
    lines = []
    for k, v in d.items():
        for item in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(item, dict):
                body = emit_prototxt(item, indent=indent + 1)
                lines.append(f"{pad}{k} {{")
                if body:
                    lines.append(body)
                lines.append(pad + "}")
            else:
                lines.append(f"{pad}{k}: {_emit_value(k, item)}")
    return "\n".join(lines)


def solver_config_from_prototxt(text: str):
    """solver.prototxt -> (SolverConfig, extras dict with the loop-level
    fields: max_iter/test_interval/snapshot/snapshot_prefix/random_seed/
    display)."""
    from ..training.optim import SolverConfig

    d = parse_prototxt(text)

    def last(key, default=None):
        v = d.get(key, default)
        return v[-1] if isinstance(v, list) else v

    t = last("type")
    if t is None and "solver_type" in d:
        t = _LEGACY_TYPES.get(str(last("solver_type")).upper())
    t = (t or "SGD").lower()
    if t not in ("sgd", "nesterov", "adagrad", "rmsprop", "adadelta",
                 "adam"):
        raise ValueError(f"unknown solver type {t!r}")
    stepvalues = d.get("stepvalue", ())
    if not isinstance(stepvalues, (list, tuple)):
        stepvalues = (stepvalues,)
    # defaults mirror SolverParameter's proto defaults exactly (fields
    # without a declared default read as 0/empty) so an omitted field
    # means the same thing it means to the reference -- e.g. momentum has
    # NO default, so absent momentum is 0, not some house value
    cfg = SolverConfig(
        solver_type=t,
        base_lr=float(last("base_lr", 0.0)),
        lr_policy=str(last("lr_policy", "fixed")),
        gamma=float(last("gamma", 0.0)),
        power=float(last("power", 0.0)),
        stepsize=int(last("stepsize", 0)),  # proto default 0, like the rest
        stepvalues=tuple(int(v) for v in stepvalues),
        max_iter=int(last("max_iter", 40001)),
        momentum=float(last("momentum", 0.0)),
        momentum2=float(last("momentum2", 0.999)),
        rms_decay=float(last("rms_decay", 0.99)),
        delta=float(last("delta", 1e-8)),
        weight_decay=float(last("weight_decay", 0.0)),
        regularization_type=str(last("regularization_type", "L2")),
        clip_gradients=float(last("clip_gradients", -1.0)),
        iter_size=int(last("iter_size", 1)),
    )
    if cfg.lr_policy == "step" and cfg.stepsize <= 0:
        # the reference would integer-divide by zero in GetLearningRate
        # (sgd_solver.cpp:37); fail loudly instead of inventing a default
        raise ValueError("lr_policy 'step' requires stepsize > 0 "
                         "(omitted stepsize reads as the proto default 0)")
    extras = {
        "max_iter": int(last("max_iter", 40001)),
        "test_interval": int(last("test_interval", 0)),  # proto default 0
        "snapshot": int(last("snapshot", 0)),
        "snapshot_prefix": last("snapshot_prefix"),
        "random_seed": last("random_seed"),
        "display": int(last("display", 50)),
    }
    return cfg, extras


def model_config_from_net_prototxt(text: str, **overrides):
    """A QA-script-generated net prototxt (network_v3/v4/v4_2/v5 family,
    do_trec_qa_clean.py:377-605) -> MMSQAConfig.

    Walks the layer list in order and reads the architecture back out:
    Embed (vocab/input_dim + embed dim), SimCross (dist_mode /
    mesure_count / bias_term), the conv->BN->pool->TanH blocks
    (kernel_h/w, num_output, pool AVE/MAX, pool kernel/stride), the two
    InnerProducts (fc1 width, class count) and the two dropouts.  The
    token lengths are data-shape facts not present in the prototxt --
    pass ``question_len``/``answer_len`` (or any other field) as
    overrides.  Raises for graphs outside the MMS family (this framework
    builds models from typed configs, not arbitrary DAGs -- PARITY.md's
    stated design stance)."""
    import dataclasses

    from ..models.mms_qa import ConvBlock, MMSQAConfig

    d = upgrade_net_prototxt(parse_prototxt(text))
    layers = d.get("layer", [])
    if isinstance(layers, dict):
        layers = [layers]
    if not layers:
        raise ValueError("no layer {} blocks found (non-net prototxt?)")

    fields: dict = {}
    blocks = []
    current = None          # pending (kh, kw, out) awaiting its pool
    ip_dims = []
    saw_sim = False

    one = _one_last  # module-level helper

    for layer in layers:
        t = layer.get("type", "")
        if t == "Embed" and "embed" not in fields:
            ep = layer.get("embed_param", {})
            fields["embed_dim"] = int(one(ep.get("num_output"), 50))
            fields["vocab_size"] = int(one(ep.get("input_dim"), 100))
            fields["embed"] = True
        elif t == "SimCross":
            sp = layer.get("sim_cross_param", {})
            fields["sim_mode"] = int(one(sp.get("dist_mode"), 0))
            fields["sim_measures"] = int(one(sp.get("mesure_count"), 1))
            fields["sim_bias"] = bool(one(sp.get("bias_term"), False))
            saw_sim = True
        elif t == "Dropout":
            ratio = float(one(layer.get("dropout_param", {})
                              .get("dropout_ratio"), 0.5))
            if saw_sim and not blocks and current is None and not ip_dims:
                fields["sim_dropout"] = ratio
            elif ip_dims:
                fields["fc1_dropout"] = ratio
        elif t == "Convolution":
            cp = layer.get("convolution_param", {})
            ks = one(cp.get("kernel_size"), 1)  # square (legacy/upgraded)
            current = (int(one(cp.get("kernel_h"), ks)),
                       int(one(cp.get("kernel_w"), ks)),
                       int(one(cp.get("num_output"))))
        elif t == "Pooling" and current is not None:
            pp = layer.get("pooling_param", {})
            pool = str(one(pp.get("pool"), "MAX")).lower()
            if pool in ("0", "1"):  # enum by number
                pool = "max" if pool == "0" else "ave"
            ks = one(pp.get("kernel_size"), 1)
            st = one(pp.get("stride"), 1)
            blocks.append(ConvBlock(current[0], current[1], current[2],
                                    pool,
                                    int(one(pp.get("kernel_h"), ks)),
                                    int(one(pp.get("stride_h"), st))))
            current = None
        elif t == "InnerProduct":
            ip_dims.append(int(one(layer.get("inner_product_param", {})
                                   .get("num_output"))))
    if "embed" not in fields or not saw_sim or not blocks \
            or len(ip_dims) < 2:
        raise ValueError(
            "not an MMS-family net (need Embed + SimCross + conv blocks "
            "+ two InnerProducts); this framework instantiates models "
            "from typed configs, not arbitrary prototxt DAGs")
    fields.pop("embed")
    # a net with no Dropout layer has NO dropout -- never inherit the V4
    # defaults for a net that didn't declare them
    fields.setdefault("sim_dropout", 0.0)
    fields.setdefault("fc1_dropout", 0.0)
    cfg = MMSQAConfig(
        blocks=tuple(blocks), fc1_dim=ip_dims[0],
        num_classes=ip_dims[-1], **fields)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def solver_prototxt_from_config(trainer_cfg, *, train_net="train.prototxt",
                                test_net=None) -> str:
    """TrainerConfig -> a solver.prototxt the reference can consume (the
    reverse of solver_config_from_prototxt; round-trips exactly)."""
    s = trainer_cfg.solver
    type_names = {"sgd": "SGD", "nesterov": "Nesterov",
                  "adagrad": "AdaGrad", "rmsprop": "RMSProp",
                  "adadelta": "AdaDelta", "adam": "Adam"}
    lines = [f'train_net: "{train_net}"']
    if test_net:
        lines += [f'test_net: "{test_net}"', "test_iter: 1"]
    lines += [
        f"test_interval: {trainer_cfg.test_interval}",
        f"base_lr: {s.base_lr}",
        f"display: {trainer_cfg.display}",
        f"max_iter: {trainer_cfg.max_iter}",
        f'lr_policy: "{s.lr_policy}"',
        # written unconditionally (inert for policies that ignore them)
        # so export -> ingest is the exact identity
        f"gamma: {s.gamma}",
        f"power: {s.power}",
        f"stepsize: {s.stepsize}",
    ]
    for v in s.stepvalues:
        lines.append(f"stepvalue: {v}")
    lines += [
        f"momentum: {s.momentum}",
        f"weight_decay: {s.weight_decay}",
        f'regularization_type: "{s.regularization_type}"',
        f"snapshot: {trainer_cfg.snapshot_interval}",
        f'snapshot_prefix: "{trainer_cfg.snapshot_prefix}"',
        f"random_seed: {trainer_cfg.seed}",
        f"delta: {s.delta}",
        f'type: "{type_names[s.solver_type]}"',
    ]
    if s.clip_gradients > 0:
        lines.append(f"clip_gradients: {s.clip_gradients}")
    if s.iter_size != 1:
        lines.append(f"iter_size: {s.iter_size}")
    if s.solver_type == "adam":
        lines.append(f"momentum2: {s.momentum2}")
    if s.solver_type == "rmsprop":
        lines.append(f"rms_decay: {s.rms_decay}")
    return "\n".join(lines) + "\n"


def net_prototxt_from_config(cfg, *, batch_size=50, source="train.txt",
                             phase="train") -> str:
    """MMSQAConfig -> a reference-loadable train-net prototxt in the
    QA script's network_v* shape (do_trec_qa_clean.py:452-498): HDF5Data ->
    shared Embed pair -> SimCross -> [Dropout] -> conv/BN/pool/TanH
    blocks -> Flatten+Concat -> fc1 -> TanH -> [Dropout] -> fc2 ->
    SoftmaxWithLoss (+ the eval heads when phase='eval').  Round-trips
    through model_config_from_net_prototxt exactly (tested)."""
    L = []
    tops = ['top: "question" top: "answer" top: "label"']
    if phase == "eval":
        tops.append('top: "group"')
    tops.append('top: "overlap_feat"')
    shuffle = "true" if phase == "train" else "false"
    L.append(f'layer {{ name: "data" type: "HDF5Data" {" ".join(tops)}\n'
             f'  hdf5_data_param {{ source: "{source}" '
             f'batch_size: {batch_size} shuffle: {shuffle} }} }}')
    for nm, bottom in (("w2v_q", "question"), ("w2v_a", "answer")):
        L.append(
            f'layer {{ name: "{nm}" type: "Embed" bottom: "{bottom}" '
            f'top: "{nm}"\n'
            f'  param {{ name: "w2v-weights" lr_mult: 1 decay_mult: 0 }}\n'
            f'  param {{ name: "w2v-bias" lr_mult: 2 decay_mult: 0 }}\n'
            f'  embed_param {{ num_output: {cfg.embed_dim} '
            f'input_dim: {cfg.vocab_size}\n'
            f'    weight_filler {{ type: "uniform" '
            f'min: -{cfg.embed_init_range} max: {cfg.embed_init_range} }} '
            f'}} }}')
    bias = "true" if cfg.sim_bias else "false"
    L.append(
        'layer { name: "sim_cross" type: "SimCross" bottom: "w2v_q" '
        'bottom: "w2v_a" top: "sim_cross"\n'
        '  param { name: "embed-weights" decay_mult: 1 lr_mult: 1 }\n'
        f'  sim_cross_param {{ dist_mode: {cfg.sim_mode} '
        f'mesure_count: {cfg.sim_measures} bias_term: {bias} }} }}')
    prev = "sim_cross"
    if cfg.sim_dropout > 0:
        L.append(f'layer {{ name: "sim_drop" type: "Dropout" '
                 f'bottom: "{prev}" top: "sim_drop"\n'
                 f'  dropout_param {{ dropout_ratio: {cfg.sim_dropout} }} '
                 f'}}')
        prev = "sim_drop"
    for i, b in enumerate(cfg.blocks):
        L.append(
            f'layer {{ name: "conv{i}" type: "Convolution" '
            f'bottom: "{prev}" top: "conv{i}"\n'
            f'  param {{ name: "conv_{i}_w" lr_mult: 1 }}\n'
            f'  param {{ name: "conv_{i}_b" lr_mult: 2 decay_mult: 0 }}\n'
            f'  convolution_param {{ kernel_h: {b.kh} kernel_w: {b.kw} '
            f'stride: 1 num_output: {b.out_channels}\n'
            f'    weight_filler {{ type: "xavier" }} }} }}')
        L.append(
            f'layer {{ name: "bn{i}" type: "BN" bottom: "conv{i}" '
            f'top: "bn{i}"\n'
            # the QA script pins the running-stat blobs at lr_mult 0
            # (do_trec_qa_clean.py:357-359) -- omitting these specs would
            # let a reference run solver-update the BN statistics
            f'  param {{ name: "bn_{i}_shape" lr_mult: 1 decay_mult: 0 }}\n'
            f'  param {{ name: "bn_{i}_shift" lr_mult: 1 decay_mult: 0 }}\n'
            f'  param {{ name: "bn_{i}_mean" lr_mult: 0 decay_mult: 0 }}\n'
            f'  param {{ name: "bn_{i}_variance" lr_mult: 0 '
            f'decay_mult: 0 }}\n'
            f'  bn_param {{ scale_filler {{ type: "constant" value: 1 }}\n'
            f'    shift_filler {{ type: "constant" '
            f'value: {cfg.bn_shift_init} }} }} }}')
        pool = "AVE" if b.pool == "ave" else "MAX"
        L.append(
            f'layer {{ name: "pool{i}" type: "Pooling" bottom: "bn{i}" '
            f'top: "pool{i}"\n'
            f'  pooling_param {{ pool: {pool} kernel_h: {b.pool_k} '
            f'kernel_w: {b.pool_k} stride_h: {b.pool_stride} '
            f'stride_w: {b.pool_stride} }} }}')
        L.append(f'layer {{ name: "relu{i}" type: "TanH" '
                 f'bottom: "pool{i}" top: "pool{i}" }}')
        prev = f"pool{i}"
    L.append(f'layer {{ name: "flt" type: "Flatten" bottom: "{prev}" '
             f'top: "flt" }}')
    L.append('layer { name: "feat" type: "Concat" bottom: "flt" '
             'bottom: "overlap_feat" top: "feat"\n'
             '  concat_param { concat_dim: 1 } }')
    L.append(
        f'layer {{ name: "fc1" type: "InnerProduct" bottom: "feat" '
        f'top: "fc1"\n'
        f'  param {{ name: "fc1-w" lr_mult: 1 decay_mult: 0 }}\n'
        f'  param {{ name: "fc1-b" lr_mult: 2 decay_mult: 0 }}\n'
        f'  inner_product_param {{ num_output: {cfg.fc1_dim}\n'
        f'    weight_filler {{ type: "xavier" }} }} }}')
    L.append('layer { name: "relu_fc1" type: "TanH" bottom: "fc1" '
             'top: "fc1" }')
    prev = "fc1"
    if cfg.fc1_dropout > 0:
        L.append(f'layer {{ name: "drop1" type: "Dropout" '
                 f'bottom: "{prev}" top: "{prev}"\n'
                 f'  dropout_param {{ dropout_ratio: {cfg.fc1_dropout} }} '
                 f'}}')
    L.append(
        f'layer {{ name: "fc2" type: "InnerProduct" bottom: "{prev}" '
        f'top: "fc2"\n'
        f'  param {{ name: "fc2-w" lr_mult: 1 decay_mult: 0 }}\n'
        f'  param {{ name: "fc2-b" lr_mult: 2 decay_mult: 0 }}\n'
        f'  inner_product_param {{ num_output: {cfg.num_classes}\n'
        f'    weight_filler {{ type: "xavier" }} }} }}')  # :438-440
    L.append('layer { name: "loss" type: "SoftmaxWithLoss" '
             'bottom: "fc2" bottom: "label" top: "loss" }')
    if phase == "eval":
        L.append('layer { name: "prob" type: "Softmax" bottom: "fc2" '
                 'top: "prob" }')
        L.append('layer { name: "mrr" type: "MRR" bottom: "prob" '
                 'bottom: "label" bottom: "group" top: "mrr" }')
        L.append('layer { name: "map" type: "MAP" bottom: "prob" '
                 'bottom: "label" bottom: "group" top: "map" }')
        L.append('layer { name: "auc" type: "AUC" bottom: "prob" '
                 'bottom: "label" top: "auc" }')
    return "\n".join(L) + "\n"


def trainer_config_from_prototxt(text: str, **overrides):
    """solver.prototxt -> TrainerConfig (our training-loop knobs driven by
    the reference's SolverParameter fields); keyword overrides win."""
    from ..training.trainer import TrainerConfig

    solver, ex = solver_config_from_prototxt(text)
    kwargs = dict(
        solver=solver,
        max_iter=ex["max_iter"],
        # 0 (the proto default) means "never test" in the reference
        # (TestAll gated on test_interval, solver.cpp:204-212) -- honored
        # by the trainer, not coerced to a house default
        test_interval=ex["test_interval"],
        snapshot_interval=ex["snapshot"],
        display=ex["display"],
    )
    if ex["random_seed"] is not None:
        kwargs["seed"] = int(ex["random_seed"])
    if ex["snapshot_prefix"]:
        import os
        kwargs["snapshot_prefix"] = os.path.basename(
            str(ex["snapshot_prefix"]))
    kwargs.update(overrides)
    return TrainerConfig(**kwargs)


# ---------------------------------------------------------------------------
# Non-QA model families: PairImage (siamese image-pair metric, SURVEY §2.1
# PairImageData row) and CaptionImage (cross-modal caption->image) as
# reference-loadable prototxt, both directions.  Every layer used is in the
# reference's vocabulary (PairImageData/Slice/Convolution/BN/Pooling/TanH/
# InnerProduct/PairRankLoss/RankAccuracy; HDF5Data/Embed/SimCross/
# Reduction for the cross-modal net), so the exported graphs load in the
# reference unmodified.
# ---------------------------------------------------------------------------


def _conv_tower(L, prefix_in: str, blocks, *, suffix: str = "",
                channels_note: int | None = None):
    """Emit a conv->BN->pool->TanH tower; param names are shared across
    towers (the siamese weight tying the reference gets from named
    ParamSpecs)."""
    prev = prefix_in
    for i, b in enumerate(blocks):
        L.append(
            f'layer {{ name: "conv{i}{suffix}" type: "Convolution" '
            f'bottom: "{prev}" top: "conv{i}{suffix}"\n'
            f'  param {{ name: "conv_{i}_w" lr_mult: 1 }}\n'
            f'  param {{ name: "conv_{i}_b" lr_mult: 2 decay_mult: 0 }}\n'
            f'  convolution_param {{ kernel_h: {b.kh} kernel_w: {b.kw} '
            f'stride: 1 num_output: {b.out_channels}\n'
            f'    weight_filler {{ type: "xavier" }} }} }}')
        L.append(
            f'layer {{ name: "bn{i}{suffix}" type: "BN" '
            f'bottom: "conv{i}{suffix}" top: "bn{i}{suffix}"\n'
            f'  param {{ name: "bn_{i}_shape" lr_mult: 1 decay_mult: 0 }}\n'
            f'  param {{ name: "bn_{i}_shift" lr_mult: 1 decay_mult: 0 }}\n'
            f'  param {{ name: "bn_{i}_mean" lr_mult: 0 decay_mult: 0 }}\n'
            f'  param {{ name: "bn_{i}_variance" lr_mult: 0 '
            f'decay_mult: 0 }}\n'
            f'  bn_param {{ scale_filler {{ type: "constant" value: 1 }} '
            f'}} }}')
        pool = "AVE" if b.pool == "ave" else "MAX"
        L.append(
            f'layer {{ name: "pool{i}{suffix}" type: "Pooling" '
            f'bottom: "bn{i}{suffix}" top: "pool{i}{suffix}"\n'
            f'  pooling_param {{ pool: {pool} kernel_h: {b.pool_k} '
            f'kernel_w: {b.pool_k} stride_h: {b.pool_stride} '
            f'stride_w: {b.pool_stride} }} }}')
        L.append(f'layer {{ name: "tanh{i}{suffix}" type: "TanH" '
                 f'bottom: "pool{i}{suffix}" top: "pool{i}{suffix}" }}')
        prev = f"pool{i}{suffix}"
    return prev


def pair_image_net_prototxt(cfg, *, source="pairs.txt",
                            batch_size=32) -> str:
    """PairImageConfig -> a reference-loadable train prototxt: the
    PairImageData layer stacks the pair on the channel axis
    (pair_image_data_layer.cpp:26-178), a Slice splits it back, two
    weight-tied conv towers score each image, PairRankLoss ranks them
    (pair_rank_loss_layer.cpp:26-52), RankAccuracy evaluates."""
    L = []
    L.append(
        f'layer {{ name: "data" type: "PairImageData" top: "data" '
        f'top: "label"\n'
        f'  pair_image_data_param {{ source: "{source}" '
        f'batch_size: {batch_size} shuffle: true '
        f'new_height: {cfg.height} new_width: {cfg.width} '
        f'is_color: {"true" if cfg.channels == 3 else "false"} }} }}')
    L.append(
        f'layer {{ name: "slice_pair" type: "Slice" bottom: "data" '
        f'top: "img1" top: "img2"\n'
        f'  slice_param {{ axis: 1 slice_point: {cfg.channels} }} }}')
    heads = []
    for j, img in enumerate(("img1", "img2")):
        prev = _conv_tower(L, img, cfg.blocks, suffix=f"_{j}")
        L.append(
            f'layer {{ name: "fc_{j}" type: "InnerProduct" '
            f'bottom: "{prev}" top: "fc_{j}"\n'
            f'  param {{ name: "fc-w" lr_mult: 1 }}\n'
            f'  param {{ name: "fc-b" lr_mult: 2 decay_mult: 0 }}\n'
            f'  inner_product_param {{ num_output: {cfg.fc_dim}\n'
            f'    weight_filler {{ type: "xavier" }} }} }}')
        L.append(f'layer {{ name: "fc_tanh_{j}" type: "TanH" '
                 f'bottom: "fc_{j}" top: "fc_{j}" }}')
        L.append(
            f'layer {{ name: "score_{j}" type: "InnerProduct" '
            f'bottom: "fc_{j}" top: "score_{j}"\n'
            f'  param {{ name: "score-w" lr_mult: 1 }}\n'
            f'  param {{ name: "score-b" lr_mult: 2 decay_mult: 0 }}\n'
            f'  inner_product_param {{ num_output: 1\n'
            f'    weight_filler {{ type: "xavier" }} }} }}')
        heads.append(f"score_{j}")
    L.append(
        f'layer {{ name: "loss" type: "PairRankLoss" '
        f'bottom: "{heads[0]}" bottom: "{heads[1]}" bottom: "label" '
        f'top: "loss"\n'
        f'  pair_rank_loss_param {{ margin: {cfg.margin} }} }}')
    L.append(
        f'layer {{ name: "rank_acc" type: "RankAccuracy" '
        f'bottom: "{heads[0]}" bottom: "{heads[1]}" bottom: "label" '
        f'top: "rank_acc" }}')
    return "\n".join(L) + "\n"


def pair_image_config_from_net_prototxt(text: str, **overrides):
    """The reverse: recover PairImageConfig from a pair-image prototxt
    (ours, or any net in the same PairImageData + towers + PairRankLoss
    shape).  Image channel count comes from the Slice point; height/width
    from pair_image_data_param's new_height/new_width when present
    (otherwise pass overrides -- they are data facts)."""
    import dataclasses as dc

    from ..models.pair_image import PairImageConfig
    from ..models.mms_qa import ConvBlock

    d = upgrade_net_prototxt(parse_prototxt(text))
    layers = d.get("layer", [])
    if isinstance(layers, dict):
        layers = [layers]

    one = _one_last  # module-level helper

    fields: dict = {}
    blocks = []
    current = None
    ip_dims = []
    seen_tower = set()

    for layer in layers:
        t = layer.get("type", "")
        name = str(layer.get("name", ""))
        if t == "PairImageData":
            pp = layer.get("pair_image_data_param", {})
            if one(pp.get("new_height"), 0):
                fields["height"] = int(one(pp.get("new_height")))
            if one(pp.get("new_width"), 0):
                fields["width"] = int(one(pp.get("new_width")))
            if one(pp.get("is_color")) is not None:
                fields["channels"] = 3 if one(pp.get("is_color")) else 1
        elif t == "Slice":
            sp = layer.get("slice_param", {})
            if one(sp.get("slice_point")) is not None:
                fields["channels"] = int(one(sp.get("slice_point")))
        elif t == "Convolution":
            base = name.rsplit("_", 1)[0]  # conv0_0 / conv0_1 -> conv0
            if base in seen_tower:  # second tower repeats the shared stack
                current = None
                continue
            seen_tower.add(base)
            cp = layer.get("convolution_param", {})
            ks = one(cp.get("kernel_size"), 1)
            current = (int(one(cp.get("kernel_h"), ks)),
                       int(one(cp.get("kernel_w"), ks)),
                       int(one(cp.get("num_output"))))
        elif t == "Pooling" and current is not None:
            pp = layer.get("pooling_param", {})
            pool = str(one(pp.get("pool"), "MAX")).lower()
            ks = one(pp.get("kernel_size"), 1)
            st = one(pp.get("stride"), 1)
            blocks.append(ConvBlock(current[0], current[1], current[2],
                                    "ave" if pool == "ave" else "max",
                                    int(one(pp.get("kernel_h"), ks)),
                                    int(one(pp.get("stride_h"), st))))
            current = None
        elif t == "InnerProduct":
            base = name.rsplit("_", 1)[0]
            if base in seen_tower:
                continue
            seen_tower.add(base)
            ip_dims.append(int(one(layer.get("inner_product_param", {})
                                   .get("num_output"))))
        elif t == "PairRankLoss":
            fields["margin"] = float(one(
                layer.get("pair_rank_loss_param", {}).get("margin"), 1.0))
    if not blocks or not ip_dims:
        raise ValueError("not a pair-image net (need conv towers + "
                         "InnerProduct score heads + PairRankLoss)")
    # the last IP is the scalar score head; the one before is fc_dim
    if len(ip_dims) >= 2:
        fields["fc_dim"] = ip_dims[-2]
    cfg = PairImageConfig(blocks=tuple(blocks), **fields)
    if overrides:
        cfg = dc.replace(cfg, **overrides)
    return cfg


def caption_image_net_prototxt(cfg, *, source="train.txt",
                               batch_size=32) -> str:
    """CaptionImageConfig -> reference-loadable prototxt.  The MaxSim
    reduction IS expressible in the reference vocabulary: SimCross emits
    (N, M, W1, P) in caffe layout, a MAX Pooling with kernel (1, P)
    collapses the patch axis, and a SUM Reduction over axis 1 yields the
    scalar score -- done per (positive, negative) image tower, ranked by
    PairRankLoss."""
    h, w = cfg.patch_grid()
    p = h * w
    L = []
    L.append(
        f'layer {{ name: "data" type: "HDF5Data" top: "caption" '
        f'top: "image_pos" top: "image_neg" top: "label"\n'
        f'  hdf5_data_param {{ source: "{source}" '
        f'batch_size: {batch_size} shuffle: true }} }}')
    L.append(
        f'layer {{ name: "w2v" type: "Embed" bottom: "caption" '
        f'top: "w2v"\n'
        f'  param {{ name: "w2v-weights" lr_mult: 1 decay_mult: 0 }}\n'
        f'  param {{ name: "w2v-bias" lr_mult: 2 decay_mult: 0 }}\n'
        f'  embed_param {{ num_output: {cfg.embed_dim} '
        f'input_dim: {cfg.vocab_size} }} }}')
    scores = []
    for j, img in enumerate(("image_pos", "image_neg")):
        prev = _conv_tower(L, img, cfg.blocks, suffix=f"_{j}")
        L.append(
            f'layer {{ name: "proj_{j}" type: "InnerProduct" '
            f'bottom: "{prev}" top: "proj_{j}"\n'
            f'  param {{ name: "proj-w" lr_mult: 1 }}\n'
            f'  param {{ name: "proj-b" lr_mult: 2 decay_mult: 0 }}\n'
            f'  inner_product_param {{ num_output: {cfg.embed_dim} '
            f'axis: 2\n'
            f'    weight_filler {{ type: "xavier" }} }} }}')
        L.append(f'layer {{ name: "proj_tanh_{j}" type: "TanH" '
                 f'bottom: "proj_{j}" top: "proj_{j}" }}')
        L.append(
            f'layer {{ name: "sim_{j}" type: "SimCross" bottom: "w2v" '
            f'bottom: "proj_{j}" top: "sim_{j}"\n'
            f'  param {{ name: "metric-weights" decay_mult: 1 '
            f'lr_mult: 1 }}\n'
            f'  sim_cross_param {{ dist_mode: 2 '
            f'mesure_count: {cfg.sim_measures} bias_term: false\n'
            f'    weight_filler {{ type: "xavier" }} }} }}')
        L.append(
            f'layer {{ name: "maxsim_{j}" type: "Pooling" '
            f'bottom: "sim_{j}" top: "maxsim_{j}"\n'
            f'  pooling_param {{ pool: MAX kernel_h: 1 kernel_w: {p} '
            f'stride: 1 }} }}')
        L.append(
            f'layer {{ name: "score_{j}" type: "Reduction" '
            f'bottom: "maxsim_{j}" top: "score_{j}"\n'
            f'  reduction_param {{ operation: SUM axis: 1 }} }}')
        scores.append(f"score_{j}")
    L.append(
        f'layer {{ name: "loss" type: "PairRankLoss" '
        f'bottom: "{scores[0]}" bottom: "{scores[1]}" bottom: "label" '
        f'top: "loss"\n'
        f'  pair_rank_loss_param {{ margin: {cfg.margin} }} }}')
    return "\n".join(L) + "\n"


def caption_image_config_from_net_prototxt(text: str, **overrides):
    """Recover CaptionImageConfig from a caption-image prototxt.  Image
    height/width/channels and caption length are data facts -- pass them
    as overrides when they differ from the defaults."""
    import dataclasses as dc

    from ..models.caption_image import CaptionImageConfig
    from ..models.mms_qa import ConvBlock

    d = upgrade_net_prototxt(parse_prototxt(text))
    layers = d.get("layer", [])
    if isinstance(layers, dict):
        layers = [layers]

    one = _one_last  # module-level helper

    fields: dict = {}
    blocks = []
    current = None
    seen_tower = set()
    saw_sim = False

    for layer in layers:
        t = layer.get("type", "")
        name = str(layer.get("name", ""))
        base = name.rsplit("_", 1)[0]
        if t == "Embed":
            ep = layer.get("embed_param", {})
            fields["embed_dim"] = int(one(ep.get("num_output"), 50))
            fields["vocab_size"] = int(one(ep.get("input_dim"), 100))
        elif t == "Convolution":
            if base in seen_tower:
                current = None
                continue
            seen_tower.add(base)
            cp = layer.get("convolution_param", {})
            ks = one(cp.get("kernel_size"), 1)
            current = (int(one(cp.get("kernel_h"), ks)),
                       int(one(cp.get("kernel_w"), ks)),
                       int(one(cp.get("num_output"))))
        elif t == "Pooling" and current is not None:
            pp = layer.get("pooling_param", {})
            pool = str(one(pp.get("pool"), "MAX")).lower()
            ks = one(pp.get("kernel_size"), 1)
            st = one(pp.get("stride"), 1)
            blocks.append(ConvBlock(current[0], current[1], current[2],
                                    "ave" if pool == "ave" else "max",
                                    int(one(pp.get("kernel_h"), ks)),
                                    int(one(pp.get("stride_h"), st))))
            current = None
        elif t == "SimCross" and base not in seen_tower:
            seen_tower.add(base)
            sp = layer.get("sim_cross_param", {})
            fields["sim_measures"] = int(one(sp.get("mesure_count"), 1))
            saw_sim = True
        elif t == "PairRankLoss":
            fields["margin"] = float(one(
                layer.get("pair_rank_loss_param", {}).get("margin"), 1.0))
    if "embed_dim" not in fields or not saw_sim or not blocks:
        raise ValueError("not a caption-image net (need Embed + conv "
                         "towers + SimCross)")
    cfg = CaptionImageConfig(blocks=tuple(blocks), **fields)
    if overrides:
        cfg = dc.replace(cfg, **overrides)
    return cfg
