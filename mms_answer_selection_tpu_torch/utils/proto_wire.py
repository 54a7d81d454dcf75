"""Binary NetParameter <-> parsed-dict codec (schema-table driven).

The wire-level half of ``tools/upgrade_net_proto_binary.cpp``: decode a
(possibly V0/V1-era) binary NetParameter into the SAME dict shape
`utils.prototxt.parse_prototxt` produces from text (repeated fields as
lists, sub-messages as dicts, enums as their NAME strings), so the
existing dict-level upgrade (`upgrade_net_prototxt`) applies unchanged;
then re-encode the modern dict to binary LayerParameter wire format.

BlobProto payloads pass through OPAQUELY as ``bytes`` — the upgrade
never rewrites weight data, it only moves the blob list to the modern
field number (net upgrades in upgrade_proto.cpp likewise copy blobs
verbatim).  Unknown fields are collected per-message in a ``_unknown``
list but NOT re-encoded — V1 and modern LayerParameter reuse the same
numbers for different fields, so passthrough would corrupt — and
`collect_dropped_unknowns` reports them so the caller can warn.

Schema tables transcribe the public caffe.proto field numbers (the wire
format is the spec; this is a clean-room reimplementation — no protobuf
runtime exists in this environment).
"""

from __future__ import annotations

import struct

__all__ = ["decode_net_binary", "encode_net_binary", "strip_blobs",
           "collect_dropped_unknowns"]


# ---------------------------------------------------------------------------
# enums (number <-> NAME)
# ---------------------------------------------------------------------------

_V1_LAYER_TYPE = {
    0: "NONE", 35: "ABSVAL", 1: "ACCURACY", 30: "ARGMAX", 2: "BNLL",
    3: "CONCAT", 37: "CONTRASTIVE_LOSS", 4: "CONVOLUTION", 5: "DATA",
    39: "DECONVOLUTION", 6: "DROPOUT", 32: "DUMMY_DATA",
    7: "EUCLIDEAN_LOSS", 25: "ELTWISE", 38: "EXP", 8: "FLATTEN",
    9: "HDF5_DATA", 10: "HDF5_OUTPUT", 28: "HINGE_LOSS", 11: "IM2COL",
    12: "IMAGE_DATA", 13: "INFOGAIN_LOSS", 14: "INNER_PRODUCT", 15: "LRN",
    29: "MEMORY_DATA", 16: "MULTINOMIAL_LOGISTIC_LOSS", 34: "MVN",
    17: "POOLING", 26: "POWER", 18: "RELU", 19: "SIGMOID",
    27: "SIGMOID_CROSS_ENTROPY_LOSS", 36: "SILENCE", 20: "SOFTMAX",
    21: "SOFTMAX_LOSS", 22: "SPLIT", 33: "SLICE", 23: "TANH",
    24: "WINDOW_DATA", 31: "THRESHOLD",
}
_POOL_METHOD = {0: "MAX", 1: "AVE", 2: "STOCHASTIC"}
_ELTWISE_OP = {0: "PROD", 1: "SUM", 2: "MAX"}
_NORM_REGION = {0: "ACROSS_CHANNELS", 1: "WITHIN_CHANNEL"}
_DB_BACKEND = {0: "LEVELDB", 1: "LMDB"}
_PHASE = {0: "TRAIN", 1: "TEST"}
_VARIANCE_NORM = {0: "FAN_IN", 1: "FAN_OUT", 2: "AVERAGE"}
_HINGE_NORM = {1: "L1", 2: "L2"}
_LOSS_NORMALIZATION = {0: "FULL", 1: "VALID", 2: "BATCH_SIZE", 3: "NONE"}
_SHARE_MODE = {0: "STRICT", 1: "PERMISSIVE"}
_SOLVER_TYPE = {0: "SGD", 1: "NESTEROV", 2: "ADAGRAD", 3: "RMSPROP",
                4: "ADADELTA", 5: "ADAM"}
_REDUCTION_OP = {1: "SUM", 2: "ASUM", 3: "SUMSQ", 4: "MEAN"}


def _signed(v: int) -> int:
    """Varint -> Python int with int32/int64 sign recovery: protobuf
    encodes negative int32/int64 as a 10-byte sign-extended varint, so
    any value with bit 63 set is a negative field (no NetParameter
    field legitimately holds an unsigned >= 2^63)."""
    return v - (1 << 64) if v >= 1 << 63 else v


# ---------------------------------------------------------------------------
# message schemas: name -> {field_number: (field_name, kind)}
#   kind: "i" varint int     "b" varint bool   "f" fixed32 float
#         "s" utf-8 string   "B" opaque bytes (BlobProto passthrough)
#         ("e", table) enum  ("m", msg) sub-message   "pi" packed/plain i64
# ---------------------------------------------------------------------------

_FILLER = {
    1: ("type", "s"), 2: ("value", "f"), 3: ("min", "f"), 4: ("max", "f"),
    5: ("mean", "f"), 6: ("std", "f"), 7: ("sparse", "i"),
    8: ("variance_norm", ("e", _VARIANCE_NORM)),
}
_BLOB_SHAPE = {1: ("dim", "pi")}
_NET_STATE_RULE = {
    1: ("phase", ("e", _PHASE)), 2: ("min_level", "i"),
    3: ("max_level", "i"), 4: ("stage", "s"), 5: ("not_stage", "s"),
}
_NET_STATE = {1: ("phase", ("e", _PHASE)), 2: ("level", "i"),
              3: ("stage", "s")}
_PARAM_SPEC = {
    1: ("name", "s"), 2: ("share_mode", ("e", _SHARE_MODE)),
    3: ("lr_mult", "f"), 4: ("decay_mult", "f"),
}
_TRANSFORM = {
    1: ("scale", "f"), 2: ("mirror", "b"), 3: ("crop_size", "i"),
    4: ("mean_file", "s"), 5: ("mean_value", "f"), 6: ("force_color", "b"),
    7: ("force_gray", "b"),
}
_LOSS_PARAM = {1: ("ignore_label", "i"), 2: ("normalize", "b"),
               3: ("normalization", ("e", _LOSS_NORMALIZATION))}
_ACCURACY = {1: ("top_k", "i"), 2: ("axis", "i"), 3: ("ignore_label", "i")}
_ARGMAX = {1: ("out_max_val", "b"), 2: ("top_k", "i"), 3: ("axis", "i")}
_CONCAT = {1: ("concat_dim", "i"), 2: ("axis", "i")}
_CONTRASTIVE = {1: ("margin", "f"), 2: ("legacy_version", "b")}
_CONVOLUTION = {
    1: ("num_output", "i"), 2: ("bias_term", "b"), 3: ("pad", "i"),
    4: ("kernel_size", "i"), 5: ("group", "i"), 6: ("stride", "i"),
    7: ("weight_filler", ("m", "Filler")),
    8: ("bias_filler", ("m", "Filler")), 9: ("pad_h", "i"),
    10: ("pad_w", "i"), 11: ("kernel_h", "i"), 12: ("kernel_w", "i"),
    13: ("stride_h", "i"), 14: ("stride_w", "i"), 15: ("engine", "i"),
    16: ("axis", "i"), 17: ("force_nd_im2col", "b"), 18: ("dilation", "i"),
}
_DATA = {
    1: ("source", "s"), 2: ("scale", "f"), 3: ("mean_file", "s"),
    4: ("batch_size", "i"), 5: ("crop_size", "i"), 6: ("mirror", "b"),
    7: ("rand_skip", "i"), 8: ("backend", ("e", _DB_BACKEND)),
    9: ("force_encoded_color", "b"), 10: ("prefetch", "i"),
}
_DROPOUT = {1: ("dropout_ratio", "f")}
_DUMMY_DATA = {
    1: ("data_filler", ("m", "Filler")), 2: ("num", "i"),
    3: ("channels", "i"), 4: ("height", "i"), 5: ("width", "i"),
    6: ("shape", ("m", "BlobShape")),
}
_ELTWISE = {1: ("operation", ("e", _ELTWISE_OP)), 2: ("coeff", "f"),
            3: ("stable_prod_grad", "b")}
_EXP = {1: ("base", "f"), 2: ("scale", "f"), 3: ("shift", "f")}
_FLATTEN = {1: ("axis", "i"), 2: ("end_axis", "i")}
_HDF5_DATA = {1: ("source", "s"), 2: ("batch_size", "i"),
              3: ("shuffle", "b")}
_HDF5_OUTPUT = {1: ("file_name", "s")}
_HINGE = {1: ("norm", ("e", _HINGE_NORM))}
_IMAGE_DATA = {
    1: ("source", "s"), 2: ("scale", "f"), 3: ("mean_file", "s"),
    4: ("batch_size", "i"), 5: ("crop_size", "i"), 6: ("mirror", "b"),
    7: ("rand_skip", "i"), 8: ("shuffle", "b"), 9: ("new_height", "i"),
    10: ("new_width", "i"), 11: ("is_color", "b"), 12: ("root_folder", "s"),
}
_INFOGAIN = {1: ("source", "s")}
_INNER_PRODUCT = {
    1: ("num_output", "i"), 2: ("bias_term", "b"),
    3: ("weight_filler", ("m", "Filler")),
    4: ("bias_filler", ("m", "Filler")), 5: ("axis", "i"),
    6: ("transpose", "b"),
}
_LRN = {
    1: ("local_size", "i"), 2: ("alpha", "f"), 3: ("beta", "f"),
    4: ("norm_region", ("e", _NORM_REGION)), 5: ("k", "f"),
    6: ("engine", "i"),
}
_MEMORY_DATA = {1: ("batch_size", "i"), 2: ("channels", "i"),
                3: ("height", "i"), 4: ("width", "i")}
_MVN = {1: ("normalize_variance", "b"), 2: ("across_channels", "b"),
        3: ("eps", "f")}
_POOLING = {
    1: ("pool", ("e", _POOL_METHOD)), 2: ("kernel_size", "i"),
    3: ("stride", "i"), 4: ("pad", "i"), 5: ("kernel_h", "i"),
    6: ("kernel_w", "i"), 7: ("stride_h", "i"), 8: ("stride_w", "i"),
    9: ("pad_h", "i"), 10: ("pad_w", "i"), 11: ("engine", "i"),
    12: ("global_pooling", "b"),
}
_POWER = {1: ("power", "f"), 2: ("scale", "f"), 3: ("shift", "f")}
_RELU = {1: ("negative_slope", "f"), 2: ("engine", "i")}
_SIGMOID = {1: ("engine", "i")}
_SLICE = {1: ("slice_dim", "i"), 2: ("slice_point", "i"), 3: ("axis", "i")}
_SOFTMAX = {1: ("engine", "i"), 2: ("axis", "i")}
_TANH = {1: ("engine", "i")}
_THRESHOLD = {1: ("threshold", "f")}
_WINDOW_DATA = {
    1: ("source", "s"), 2: ("scale", "f"), 3: ("mean_file", "s"),
    4: ("batch_size", "i"), 5: ("crop_size", "i"), 6: ("mirror", "b"),
    7: ("fg_threshold", "f"), 8: ("bg_threshold", "f"),
    9: ("fg_fraction", "f"), 10: ("context_pad", "i"),
    11: ("crop_mode", "s"), 12: ("cache_images", "b"),
    13: ("root_folder", "s"),
}
_INPUT = {1: ("shape", ("m", "BlobShape"))}
_PYTHON = {1: ("module", "s"), 2: ("layer", "s"), 3: ("param_str", "s"),
           4: ("share_in_parallel", "b")}
_PRELU = {1: ("filler", ("m", "Filler")), 2: ("channel_shared", "b")}
_SPP = {1: ("pyramid_height", "i"), 2: ("pool", ("e", _POOL_METHOD)),
        6: ("engine", "i")}
_RESHAPE = {1: ("shape", ("m", "BlobShape")), 2: ("axis", "i"),
            3: ("num_axes", "i")}
_LOG = {1: ("base", "f"), 2: ("scale", "f"), 3: ("shift", "f")}
_REDUCTION = {1: ("operation", ("e", _REDUCTION_OP)), 2: ("axis", "i"),
              3: ("coeff", "f")}
_EMBED = {1: ("num_output", "i"), 2: ("input_dim", "i"),
          3: ("bias_term", "b"), 4: ("weight_filler", ("m", "Filler")),
          5: ("bias_filler", ("m", "Filler")), 7: ("weight_source", "s")}
_TILE = {1: ("axis", "i"), 2: ("tiles", "i")}
_BATCH_NORM = {1: ("use_global_stats", "b"),
               2: ("moving_average_fraction", "f"), 3: ("eps", "f")}
_ELU = {1: ("alpha", "f")}
_BIAS = {1: ("axis", "i"), 2: ("num_axes", "i"),
         3: ("filler", ("m", "Filler"))}
_SCALE_P = {1: ("axis", "i"), 2: ("num_axes", "i"),
            3: ("filler", ("m", "Filler")), 4: ("bias_term", "b"),
            5: ("bias_filler", ("m", "Filler"))}
_CROP = {1: ("axis", "i"), 2: ("offset", "i")}
_PARAMETER = {1: ("shape", ("m", "BlobShape"))}
_RECURRENT = {1: ("num_output", "i"),
              2: ("weight_filler", ("m", "Filler")),
              3: ("bias_filler", ("m", "Filler")),
              4: ("debug_info", "b"), 5: ("expose_hidden", "b")}
# the fork's extension params (reference caffe.proto:407-488)
_AUC = {1: ("fixed_axis", "i"), 2: ("axis", "i"), 3: ("ignore_label", "i")}
_BN = {1: ("bn_memory", "f"), 2: ("scale_filler", ("m", "Filler")),
       3: ("shift_filler", ("m", "Filler"))}
_SIM_CROSS = {1: ("dist_mode", "i"), 2: ("mesure_count", "i"),
              3: ("weight_filler", ("m", "Filler")),
              4: ("bias_term", "b"),
              5: ("bias_filler", ("m", "Filler"))}
_PAIR_RANK_LOSS = {1: ("margin", "f")}
_PAIR_IMAGE_DATA = {
    1: ("source", "s"), 2: ("scale", "f"), 3: ("mean_file", "s"),
    4: ("batch_size", "i"), 5: ("crop_size", "i"), 6: ("mirror", "b"),
    7: ("rand_skip", "i"), 8: ("shuffle", "b"), 9: ("new_height", "i"),
    10: ("new_width", "i"), 11: ("is_color", "b"),
    12: ("root_folder", "s"),
}
_SIM_MATRIX = {1: ("weight_filler", ("m", "Filler"))}
_MRR = {1: ("fixed_axis", "i")}
_MAP = {1: ("fixed_axis", "i")}
_FM = {1: ("bias_term", "b")}

# wire-level Datum / BlobProto (caffe.proto:30-62) — the caffe_pb2-shim
# surface (utils/caffe_pb2_shim.py) and the io codecs share these
_DATUM = {
    1: ("channels", "i"), 2: ("height", "i"), 3: ("width", "i"),
    4: ("data", "B"), 5: ("label", "i"), 6: ("float_data", "pf"),
    7: ("encoded", "b"),
}
_BLOB_PROTO = {
    7: ("shape", ("m", "BlobShape")), 5: ("data", "pf"),
    6: ("diff", "pf"), 1: ("num", "i"), 2: ("channels", "i"),
    3: ("height", "i"), 4: ("width", "i"),
}
_BLOB_PROTO_VECTOR = {1: ("blobs", ("m", "BlobProto"))}

# V0LayerParameter (upgrade_proto.cpp:87-560 reads these flat fields)
_V0_LAYER = {
    1: ("name", "s"), 2: ("type", "s"), 3: ("num_output", "i"),
    4: ("biasterm", "b"), 5: ("weight_filler", ("m", "Filler")),
    6: ("bias_filler", ("m", "Filler")), 7: ("pad", "i"),
    8: ("kernelsize", "i"), 9: ("group", "i"), 10: ("stride", "i"),
    11: ("pool", ("e", _POOL_METHOD)), 12: ("dropout_ratio", "f"),
    13: ("local_size", "i"), 14: ("alpha", "f"), 15: ("beta", "f"),
    16: ("source", "s"), 17: ("scale", "f"), 18: ("meanfile", "s"),
    19: ("batchsize", "i"), 20: ("cropsize", "i"), 21: ("mirror", "b"),
    22: ("k", "f"), 50: ("blobs", "B"), 51: ("blobs_lr", "f"),
    52: ("weight_decay", "f"), 53: ("rand_skip", "i"),
    54: ("det_fg_threshold", "f"), 55: ("det_bg_threshold", "f"),
    56: ("det_fg_fraction", "f"), 58: ("det_context_pad", "i"),
    59: ("det_crop_mode", "s"),
    60: ("new_num", "i"), 61: ("new_channels", "i"),
    62: ("new_height", "i"), 63: ("new_width", "i"),
    # shuffle_images -> the text-side knob name "shuffle"
    64: ("shuffle", "b"), 65: ("concat_dim", "i"),
}

# V1LayerParameter — decode side only (the legacy input)
_V1_LAYER = {
    1: ("layer", ("m", "V0Layer")), 2: ("bottom", "s"), 3: ("top", "s"),
    4: ("name", "s"), 5: ("type", ("e", _V1_LAYER_TYPE)),
    6: ("blobs", "B"), 1001: ("param", "s"),
    1002: ("blob_share_mode", ("e", _SHARE_MODE)),
    7: ("blobs_lr", "f"), 8: ("weight_decay", "f"),
    35: ("loss_weight", "f"),
    27: ("accuracy_param", ("m", "Accuracy")),
    23: ("argmax_param", ("m", "ArgMax")),
    9: ("concat_param", ("m", "Concat")),
    40: ("contrastive_loss_param", ("m", "Contrastive")),
    10: ("convolution_param", ("m", "Convolution")),
    11: ("data_param", ("m", "Data")),
    12: ("dropout_param", ("m", "Dropout")),
    26: ("dummy_data_param", ("m", "DummyData")),
    24: ("eltwise_param", ("m", "Eltwise")),
    41: ("exp_param", ("m", "Exp")),
    13: ("hdf5_data_param", ("m", "HDF5Data")),
    14: ("hdf5_output_param", ("m", "HDF5Output")),
    29: ("hinge_loss_param", ("m", "Hinge")),
    15: ("image_data_param", ("m", "ImageData")),
    16: ("infogain_loss_param", ("m", "Infogain")),
    17: ("inner_product_param", ("m", "InnerProduct")),
    18: ("lrn_param", ("m", "LRN")),
    22: ("memory_data_param", ("m", "MemoryData")),
    34: ("mvn_param", ("m", "MVN")),
    19: ("pooling_param", ("m", "Pooling")),
    21: ("power_param", ("m", "Power")),
    30: ("relu_param", ("m", "ReLU")),
    38: ("sigmoid_param", ("m", "Sigmoid")),
    39: ("softmax_param", ("m", "Softmax")),
    31: ("slice_param", ("m", "Slice")),
    37: ("tanh_param", ("m", "TanH")),
    25: ("threshold_param", ("m", "Threshold")),
    20: ("window_data_param", ("m", "WindowData")),
    36: ("transform_param", ("m", "Transform")),
    42: ("loss_param", ("m", "LossParam")),
    32: ("include", ("m", "NetStateRule")),
    33: ("exclude", ("m", "NetStateRule")),
}

# modern LayerParameter — both directions
_LAYER = {
    1: ("name", "s"), 2: ("type", "s"), 3: ("bottom", "s"),
    4: ("top", "s"), 10: ("phase", ("e", _PHASE)),
    5: ("loss_weight", "f"), 6: ("param", ("m", "ParamSpec")),
    7: ("blobs", "B"), 11: ("propagate_down", "b"),
    8: ("include", ("m", "NetStateRule")),
    9: ("exclude", ("m", "NetStateRule")),
    100: ("transform_param", ("m", "Transform")),
    101: ("loss_param", ("m", "LossParam")),
    102: ("accuracy_param", ("m", "Accuracy")),
    103: ("argmax_param", ("m", "ArgMax")),
    104: ("concat_param", ("m", "Concat")),
    105: ("contrastive_loss_param", ("m", "Contrastive")),
    106: ("convolution_param", ("m", "Convolution")),
    107: ("data_param", ("m", "Data")),
    108: ("dropout_param", ("m", "Dropout")),
    109: ("dummy_data_param", ("m", "DummyData")),
    110: ("eltwise_param", ("m", "Eltwise")),
    111: ("exp_param", ("m", "Exp")),
    112: ("hdf5_data_param", ("m", "HDF5Data")),
    113: ("hdf5_output_param", ("m", "HDF5Output")),
    114: ("hinge_loss_param", ("m", "Hinge")),
    115: ("image_data_param", ("m", "ImageData")),
    116: ("infogain_loss_param", ("m", "Infogain")),
    117: ("inner_product_param", ("m", "InnerProduct")),
    118: ("lrn_param", ("m", "LRN")),
    119: ("memory_data_param", ("m", "MemoryData")),
    120: ("mvn_param", ("m", "MVN")),
    121: ("pooling_param", ("m", "Pooling")),
    122: ("power_param", ("m", "Power")),
    123: ("relu_param", ("m", "ReLU")),
    124: ("sigmoid_param", ("m", "Sigmoid")),
    125: ("softmax_param", ("m", "Softmax")),
    126: ("slice_param", ("m", "Slice")),
    127: ("tanh_param", ("m", "TanH")),
    128: ("threshold_param", ("m", "Threshold")),
    129: ("window_data_param", ("m", "WindowData")),
    130: ("python_param", ("m", "Python")),
    131: ("prelu_param", ("m", "PReLU")),
    132: ("spp_param", ("m", "SPP")),
    133: ("reshape_param", ("m", "Reshape")),
    134: ("log_param", ("m", "Log")),
    135: ("flatten_param", ("m", "Flatten")),
    136: ("reduction_param", ("m", "Reduction")),
    137: ("embed_param", ("m", "Embed")),
    138: ("tile_param", ("m", "Tile")),
    139: ("batch_norm_param", ("m", "BatchNorm")),
    140: ("elu_param", ("m", "ELU")),
    141: ("bias_param", ("m", "Bias")),
    142: ("scale_param", ("m", "ScaleParam")),
    143: ("input_param", ("m", "Input")),
    144: ("crop_param", ("m", "Crop")),
    145: ("parameter_param", ("m", "Parameter")),
    146: ("recurrent_param", ("m", "Recurrent")),
    # the fork's extension params (reference caffe.proto:407-415)
    160: ("auc_param", ("m", "AUC")),
    161: ("bn_param", ("m", "BN")),
    162: ("sim_cross_param", ("m", "SimCross")),
    163: ("pair_rank_loss_param", ("m", "PairRankLoss")),
    164: ("pair_image_data_param", ("m", "PairImageData")),
    165: ("sim_matrix_param", ("m", "SimMatrix")),
    166: ("mrr_param", ("m", "MRR")),
    167: ("map_param", ("m", "MAP")),
    168: ("fm_param", ("m", "FM")),
}

_NET = {
    1: ("name", "s"), 3: ("input", "s"),
    8: ("input_shape", ("m", "BlobShape")), 4: ("input_dim", "i"),
    5: ("force_backward", "b"), 6: ("state", ("m", "NetState")),
    7: ("debug_info", "b"), 100: ("layer", ("m", "Layer")),
    2: ("layers", ("m", "V1Layer")),
}

_SCHEMAS = {
    "Net": _NET, "Layer": _LAYER, "V1Layer": _V1_LAYER,
    "V0Layer": _V0_LAYER, "Filler": _FILLER, "BlobShape": _BLOB_SHAPE,
    "NetStateRule": _NET_STATE_RULE, "NetState": _NET_STATE,
    "ParamSpec": _PARAM_SPEC, "Transform": _TRANSFORM,
    "LossParam": _LOSS_PARAM, "Accuracy": _ACCURACY, "ArgMax": _ARGMAX,
    "Concat": _CONCAT, "Contrastive": _CONTRASTIVE,
    "Convolution": _CONVOLUTION, "Data": _DATA, "Dropout": _DROPOUT,
    "DummyData": _DUMMY_DATA, "Eltwise": _ELTWISE, "Exp": _EXP,
    "Flatten": _FLATTEN, "HDF5Data": _HDF5_DATA,
    "HDF5Output": _HDF5_OUTPUT, "Hinge": _HINGE,
    "ImageData": _IMAGE_DATA, "Infogain": _INFOGAIN,
    "InnerProduct": _INNER_PRODUCT, "LRN": _LRN,
    "MemoryData": _MEMORY_DATA, "MVN": _MVN, "Pooling": _POOLING,
    "Power": _POWER, "ReLU": _RELU, "Sigmoid": _SIGMOID,
    "Slice": _SLICE, "Softmax": _SOFTMAX, "TanH": _TANH,
    "Threshold": _THRESHOLD, "WindowData": _WINDOW_DATA,
    "Input": _INPUT, "Python": _PYTHON, "PReLU": _PRELU, "SPP": _SPP,
    "Reshape": _RESHAPE, "Log": _LOG, "Reduction": _REDUCTION,
    "Embed": _EMBED, "Tile": _TILE, "BatchNorm": _BATCH_NORM,
    "ELU": _ELU, "Bias": _BIAS, "ScaleParam": _SCALE_P, "Crop": _CROP,
    "Parameter": _PARAMETER, "Recurrent": _RECURRENT, "AUC": _AUC,
    "BN": _BN, "SimCross": _SIM_CROSS, "PairRankLoss": _PAIR_RANK_LOSS,
    "PairImageData": _PAIR_IMAGE_DATA, "SimMatrix": _SIM_MATRIX,
    "MRR": _MRR, "MAP": _MAP, "FM": _FM, "Datum": _DATUM,
    "BlobProto": _BLOB_PROTO, "BlobProtoVector": _BLOB_PROTO_VECTOR,
}

# name -> (number, kind) reverse tables, built once
_REVERSE = {m: {name: (num, kind) for num, (name, kind) in tbl.items()}
            for m, tbl in _SCHEMAS.items()}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = bytes(buf[pos:pos + ln])
            pos += ln
        elif wt == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _store(d, key, value):
    if key in d:
        if not isinstance(d[key], list):
            d[key] = [d[key]]
        d[key].append(value)
    else:
        d[key] = value


# wire types each kind can legitimately arrive as; a known field number
# carrying any OTHER wire type is treated as an unknown field (proto2's
# own semantics: wire-type mismatch goes to the unknown-field set, it is
# not a parse error) — keeps corrupted inputs from crashing the decoder
_KIND_WIRETYPES = {"i": (0, 1), "b": (0,), "f": (5,), "s": (2,),
                   "B": (2,), "pi": (0, 2), "pf": (5, 2),
                   "e": (0,), "m": (2,)}


def _decode(buf, msg: str) -> dict:
    tbl = _SCHEMAS[msg]
    out: dict = {}
    for num, wt, val in _iter_fields(buf):
        spec = tbl.get(num)
        if spec is not None:
            kind_tag = spec[1] if isinstance(spec[1], str) else spec[1][0]
            if wt not in _KIND_WIRETYPES[kind_tag]:
                spec = None
        if spec is None:
            out.setdefault("_unknown", []).append((num, wt, val))
            continue
        name, kind = spec
        if kind == "i":
            v = _signed(int(val)) if wt == 0 \
                else int.from_bytes(val, "little")
        elif kind == "b":
            v = bool(val)
        elif kind == "f":
            v = float(struct.unpack("<f", val)[0]) if wt == 5 else float(val)
        elif kind == "s":
            v = val.decode("utf-8", "replace")
        elif kind == "B":
            v = val  # opaque passthrough
        elif kind == "pi":
            if wt == 0:
                v = _signed(int(val))
            else:  # packed varints
                p, dims = 0, []
                while p < len(val):
                    d_, p = _read_varint(val, p)
                    dims.append(_signed(d_))
                for d_ in dims:
                    _store(out, name, d_)
                continue
        elif kind == "pf":
            # repeated float: one wt-5 field per element (the C++
            # runtime's default) OR a packed wt-2 run
            if wt == 5:
                v = float(struct.unpack("<f", val)[0])
            else:
                for f_ in struct.unpack(f"<{len(val) // 4}f", val):
                    _store(out, name, float(f_))
                continue
        elif kind[0] == "e":
            v = kind[1].get(int(val), int(val))
        elif kind[0] == "m":
            v = _decode(val, kind[1])
        else:  # pragma: no cover
            raise AssertionError(kind)
        _store(out, name, v)
    return out


def decode_net_binary(data: bytes) -> dict:
    """Binary NetParameter (any era) -> parse_prototxt-shaped dict.
    Blobs are ``bytes`` leaves under the layers' ``blobs`` keys."""
    return _decode(data, "Net")


# ---------------------------------------------------------------------------
# encode (modern schema only)
# ---------------------------------------------------------------------------

def _varint(n):
    out = bytearray()
    n = int(n) & ((1 << 64) - 1)  # negatives: 10-byte sign-extended form
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(num, wt):
    return _varint((num << 3) | wt)


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _encode_value(num, kind, v) -> bytes:
    if kind == "i" or kind == "pi":
        return _key(num, 0) + _varint(int(v))
    if kind == "pf":
        return _key(num, 5) + struct.pack("<f", float(v))
    if kind == "b":
        return _key(num, 0) + _varint(1 if v else 0)
    if kind == "f":
        return _key(num, 5) + struct.pack("<f", float(v))
    if kind == "s":
        payload = str(v).encode("utf-8")
        return _key(num, 2) + _varint(len(payload)) + payload
    if kind == "B":
        return _key(num, 2) + _varint(len(v)) + bytes(v)
    if kind[0] == "e":
        if isinstance(v, str):
            rev = {name: n for n, name in kind[1].items()}
            v = rev[v.upper()]
        return _key(num, 0) + _varint(int(v))
    if kind[0] == "m":
        payload = _encode(v, kind[1])
        return _key(num, 2) + _varint(len(payload)) + payload
    raise AssertionError(kind)  # pragma: no cover


def _encode(d: dict, msg: str) -> bytes:
    rev = _REVERSE[msg]
    out = bytearray()
    for name, value in d.items():
        if name == "_unknown":
            continue  # era-specific numbers: never re-emit inside layers
        spec = rev.get(name)
        if spec is None:
            raise ValueError(f"cannot encode unknown field {name!r} "
                             f"of {msg}")
        num, kind = spec
        for v in _as_list(value):
            out += _encode_value(num, kind, v)
    return bytes(out)


def encode_net_binary(d: dict) -> bytes:
    """Modern parse_prototxt-shaped NetParameter dict -> binary wire
    bytes.  ``blobs`` leaves must be ``bytes`` (opaque BlobProtos, as
    produced by decode_net_binary); raises on legacy ``layers`` — run
    `upgrade_net_prototxt` first."""
    if "layers" in d:
        raise ValueError("legacy 'layers' present: upgrade the dict with "
                         "upgrade_net_prototxt before encoding")
    return _encode(d, "Net")


# ---------------------------------------------------------------------------
# helpers for the CLI tool
# ---------------------------------------------------------------------------

def strip_blobs(d: dict):
    """Copy of the dict without ``blobs``/``_unknown`` entries — the
    text-emittable structure (blob payloads are not text)."""
    if isinstance(d, dict):
        return {k: strip_blobs(v) for k, v in d.items()
                if k not in ("blobs", "_unknown")}
    if isinstance(d, list):
        return [strip_blobs(v) for v in d]
    return d


def collect_dropped_unknowns(d: dict, path="net"):
    """[(path, field_number), ...] of unknown fields that re-encoding
    will drop (everything below the NetParameter level)."""
    out = []
    if isinstance(d, dict):
        for num, _wt, _val in d.get("_unknown", []):
            out.append((path, num))
        for k, v in d.items():
            if k == "_unknown":
                continue
            for i, item in enumerate(_as_list(v)):
                if isinstance(item, (dict, list)):
                    out.extend(collect_dropped_unknowns(
                        item, f"{path}.{k}[{i}]"))
    return out
