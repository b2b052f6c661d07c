# Copied from larynx_tpu/convert/onnx_import.py; only the package name in its imports differs.
"""ONNX checkpoint importer built on a minimal protobuf wire-format reader.

The environment ships no ``onnx`` package, so this module decodes the ONNX
ModelProto container directly (protobuf wire format) to extract the graph's
initializer tensors, then maps them into larynx_tpu parameter pytrees using
the same name-based conversion as the torch importer (ONNX files exported
from the reference training repos carry the torch state-dict parameter
names as initializer names).

Supports the voice-dir default artifact ``generator.onnx``
(larynx/glow_tts.py:98-100, larynx/hifi_gan.py:103-105 load these through
ONNX Runtime in the reference).
"""

import struct
import typing
from pathlib import Path

import numpy as np

from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.convert.torch_import import (
    StateDict,
    glow_tts_params_from_state_dict,
    hifi_gan_params_from_state_dict,
)

# --- protobuf wire format -----------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


class OnnxParseError(Exception):
    pass


def _read_varint(buf: memoryview, pos: int) -> typing.Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise OnnxParseError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise OnnxParseError("varint too long")


def iter_fields(
    buf: memoryview,
) -> typing.Iterator[typing.Tuple[int, int, typing.Any]]:
    """Yield (field_number, wire_type, value) for one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field_num = key >> 3
        wire_type = key & 0x7
        if wire_type == _WIRE_VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire_type == _WIRE_64BIT:
            value = buf[pos : pos + 8]
            pos += 8
        elif wire_type == _WIRE_LEN:
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire_type == _WIRE_32BIT:
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise OnnxParseError(f"unsupported wire type {wire_type}")
        yield field_num, wire_type, value


# --- ONNX TensorProto ---------------------------------------------------------

# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _zigzag_ok_int(v: int) -> int:
    # protobuf int64 varints are two's-complement; wrap to signed
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_tensor(buf: memoryview) -> typing.Tuple[str, np.ndarray]:
    """Decode one TensorProto into (name, ndarray)."""
    dims: typing.List[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: typing.List[float] = []
    int32_data: typing.List[int] = []
    int64_data: typing.List[int] = []
    double_data: typing.List[float] = []

    for field, wire, value in iter_fields(buf):
        if field == 1:  # dims
            if wire == _WIRE_VARINT:
                dims.append(_zigzag_ok_int(value))
            else:  # packed
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    dims.append(_zigzag_ok_int(v))
        elif field == 2:  # data_type
            data_type = value
        elif field == 4:  # float_data
            if wire == _WIRE_32BIT:
                float_data.append(struct.unpack("<f", value)[0])
            else:  # packed
                float_data.extend(
                    struct.unpack(f"<{len(value) // 4}f", bytes(value))
                )
        elif field == 5:  # int32_data
            if wire == _WIRE_VARINT:
                int32_data.append(value)
            else:
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    int32_data.append(v)
        elif field == 7:  # int64_data
            if wire == _WIRE_VARINT:
                int64_data.append(_zigzag_ok_int(value))
            else:
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    int64_data.append(_zigzag_ok_int(v))
        elif field == 8:  # name
            name = bytes(value).decode("utf-8")
        elif field == 9:  # raw_data
            raw = bytes(value)
        elif field == 10:  # double_data
            if wire == _WIRE_64BIT:
                double_data.append(struct.unpack("<d", value)[0])
            else:
                double_data.extend(
                    struct.unpack(f"<{len(value) // 8}d", bytes(value))
                )
        elif field == 13:  # external_data
            raise OnnxParseError(
                "external tensor data is not supported"
            )

    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise OnnxParseError(f"unsupported tensor dtype {data_type} for {name}")

    if raw is not None:
        array = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        array = np.asarray(float_data, dtype=dtype)
    elif double_data:
        array = np.asarray(double_data, dtype=dtype)
    elif int64_data:
        array = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        array = np.asarray(int32_data, dtype=dtype)
    else:
        array = np.zeros(0, dtype=dtype)

    if dims:
        array = array.reshape(dims)
    return name, array


def parse_node(buf: memoryview) -> typing.Dict[str, typing.Any]:
    """Decode a NodeProto into a small dict (inputs/outputs/op_type/attrs)."""
    node: typing.Dict[str, typing.Any] = {
        "input": [],
        "output": [],
        "op_type": "",
        "name": "",
        "attrs": {},
    }
    for field, _wire, value in iter_fields(buf):
        if field == 1:
            node["input"].append(bytes(value).decode("utf-8"))
        elif field == 2:
            node["output"].append(bytes(value).decode("utf-8"))
        elif field == 3:
            node["name"] = bytes(value).decode("utf-8")
        elif field == 4:
            node["op_type"] = bytes(value).decode("utf-8")
        elif field == 5:
            attr_name, attr_value = _parse_attribute(value)
            node["attrs"][attr_name] = attr_value
    return node


def _parse_attribute(buf: memoryview):
    name = ""
    out: typing.Any = None
    for field, wire, value in iter_fields(buf):
        if field == 1:
            name = bytes(value).decode("utf-8")
        elif field == 2:  # f
            out = struct.unpack("<f", value)[0]
        elif field == 3:  # i
            out = _zigzag_ok_int(value)
        elif field == 4:  # s
            out = bytes(value)
        elif field == 5:  # t (tensor)
            out = parse_tensor(value)[1]
        elif field == 7:  # floats
            out = list(struct.unpack(f"<{len(value) // 4}f", bytes(value)))
        elif field == 8:  # ints
            ints = []
            pos = 0
            while pos < len(value):
                v, pos = _read_varint(value, pos)
                ints.append(_zigzag_ok_int(v))
            out = ints
    return name, out


def read_onnx_graph(path: typing.Union[str, Path]):
    """Parse a .onnx file -> (initializers {name: array}, nodes list)."""
    data = memoryview(Path(path).read_bytes())

    graph_buf = None
    for field, wire, value in iter_fields(data):  # ModelProto
        if field == 7 and wire == _WIRE_LEN:  # graph
            graph_buf = value
            break
    if graph_buf is None:
        raise OnnxParseError("no graph in ONNX model")

    initializers: typing.Dict[str, np.ndarray] = {}
    nodes: typing.List[typing.Dict[str, typing.Any]] = []
    for field, wire, value in iter_fields(graph_buf):  # GraphProto
        if field == 5 and wire == _WIRE_LEN:  # initializer
            name, array = parse_tensor(value)
            initializers[name] = array
        elif field == 1 and wire == _WIRE_LEN:  # node
            nodes.append(parse_node(value))
    return initializers, nodes


# --- in-graph weight-norm folding ----------------------------------------------
#
# torch.onnx.export of a module that still carries weight-norm hooks emits
# ``weight_g``/``weight_v`` initializers plus the normalization itself as
# graph nodes (``Mul(g, Div(v, ReduceL2(v)))`` or the ``Pow/ReduceSum/Sqrt``
# spelling, depending on the torch/opset version).  We fold those subgraphs
# at import by constant-evaluating every node whose inputs are all known
# constants, then naming any result whose ancestry is exactly one
# ``<base>.weight_g`` + ``<base>.weight_v`` pair as ``<base>.weight`` —
# the same tensor ``remove_weight_norm`` would have produced
# (hifi_gan/models.py:204-211, applied at load in larynx/hifi_gan.py:100).


def _attr_or_input(node, attr_name, inputs, input_idx):
    """Opset drift helper: axes live in attrs (<13) or as an input (>=13)."""
    if attr_name in node["attrs"]:
        return node["attrs"][attr_name]
    if len(inputs) > input_idx and inputs[input_idx] is not None:
        return [int(v) for v in np.asarray(inputs[input_idx]).reshape(-1)]
    return None


def _eval_node(node, inputs) -> typing.Optional[np.ndarray]:
    """Evaluate one foldable node on constant inputs; None if unsupported."""
    op = node["op_type"]
    attrs = node["attrs"]
    if op == "Constant":
        value = attrs.get("value")
        return None if value is None else np.asarray(value)
    if op == "Identity":
        return inputs[0]
    if op in ("Mul", "Div", "Add", "Sub", "Pow"):
        a, b = inputs[0], inputs[1]
        fn = {
            "Mul": np.multiply,
            "Div": np.divide,
            "Add": np.add,
            "Sub": np.subtract,
            "Pow": np.power,
        }[op]
        return fn(a, b)
    if op == "Sqrt":
        return np.sqrt(inputs[0])
    if op == "Reciprocal":
        return np.reciprocal(inputs[0])
    if op == "Abs":
        return np.abs(inputs[0])
    if op in ("ReduceL2", "ReduceSum"):
        axes = _attr_or_input(node, "axes", inputs, 1)
        keepdims = bool(attrs.get("keepdims", 1))
        axis = tuple(axes) if axes is not None else None
        x = inputs[0]
        if op == "ReduceL2":
            return np.sqrt(
                np.sum(np.square(x), axis=axis, keepdims=keepdims)
            ).astype(x.dtype)
        return np.sum(x, axis=axis, keepdims=keepdims).astype(x.dtype)
    if op == "Unsqueeze":
        axes = _attr_or_input(node, "axes", inputs, 1) or []
        out = inputs[0]
        for ax in sorted(axes):
            out = np.expand_dims(out, ax)
        return out
    if op == "Squeeze":
        axes = _attr_or_input(node, "axes", inputs, 1)
        return np.squeeze(inputs[0], axis=tuple(axes) if axes else None)
    if op == "Reshape":
        return np.reshape(inputs[0], [int(v) for v in inputs[1].reshape(-1)])
    if op == "Expand":
        shape = [int(v) for v in inputs[1].reshape(-1)]
        return np.broadcast_to(inputs[0], np.broadcast_shapes(inputs[0].shape, tuple(shape))).copy()
    if op == "Cast":
        return inputs[0].astype(_DTYPES.get(attrs.get("to", 1), np.float32))
    if op == "Transpose":
        perm = attrs.get("perm")
        return np.transpose(inputs[0], perm)
    if op == "Neg":
        return -inputs[0]
    if op == "Exp":
        return np.exp(inputs[0])
    if op == "Log":
        return np.log(inputs[0])
    if op == "MatMul":
        return np.matmul(inputs[0], inputs[1])
    if op == "Concat":
        return np.concatenate(inputs, axis=int(attrs.get("axis", 0)))
    if op == "Gather":
        axis = int(attrs.get("axis", 0))
        return np.take(inputs[0], inputs[1].astype(np.int64), axis=axis)
    if op == "Slice":
        # opset >= 10: starts/ends/axes/steps as inputs
        starts = [int(v) for v in np.asarray(inputs[1]).reshape(-1)]
        ends = [int(v) for v in np.asarray(inputs[2]).reshape(-1)]
        axes = (
            [int(v) for v in np.asarray(inputs[3]).reshape(-1)]
            if len(inputs) > 3 and inputs[3] is not None
            else list(range(len(starts)))
        )
        steps = (
            [int(v) for v in np.asarray(inputs[4]).reshape(-1)]
            if len(inputs) > 4 and inputs[4] is not None
            else [1] * len(starts)
        )
        slices = [slice(None)] * inputs[0].ndim
        for ax, st, en, sp in zip(axes, starts, ends, steps):
            slices[ax] = slice(st, en, sp)
        return inputs[0][tuple(slices)]
    if op == "Shape":
        return np.asarray(inputs[0].shape, dtype=np.int64)
    if op == "ConstantOfShape":
        value = attrs.get("value")
        fill = np.asarray(value).reshape(-1)[0] if value is not None else 0.0
        shape = [int(v) for v in np.asarray(inputs[0]).reshape(-1)]
        return np.full(shape, fill)
    if op == "Range":
        return np.arange(
            int(np.asarray(inputs[0])),
            int(np.asarray(inputs[1])),
            int(np.asarray(inputs[2])),
            dtype=np.int64,
        )
    if op == "Where":
        return np.where(inputs[0], inputs[1], inputs[2])
    return None


# Ops a traced FlowGenerator / HiFi-GAN export contains that the importer
# deliberately does NOT execute — weights are recovered from initializers
# (+ constant folding), not by running the graph.  Anything outside this
# union and the _eval_node foldables is reported as unsupported.
KNOWN_RUNTIME_OPS = {
    "Conv", "ConvTranspose", "Gemm", "LeakyRelu", "Relu", "Sigmoid",
    "Tanh", "Softmax", "Softplus", "LayerNormalization", "ReduceMean",
    "ReduceMax", "ReduceMin", "Pad", "Split", "Gather", "GatherElements",
    "ScatterND", "CumSum", "Clip", "Min", "Max", "Floor", "Ceil",
    "Equal", "Greater", "Less", "Not", "And", "Or", "Erf", "Einsum",
    "Resize", "Tile", "TopK", "NonZero", "GreaterOrEqual", "LessOrEqual",
    "Dropout", "RandomNormalLike", "RandomNormal", "Loop", "If",
}

_FOLDABLE_OPS = {
    "Constant", "Identity", "Mul", "Div", "Add", "Sub", "Pow", "Sqrt",
    "Reciprocal", "Abs", "ReduceL2", "ReduceSum", "Unsqueeze", "Squeeze",
    "Reshape", "Expand", "Cast", "Transpose", "Neg", "Exp", "Log",
    "MatMul", "Concat", "Gather", "Slice", "Shape", "ConstantOfShape",
    "Range", "Where",
}


def unsupported_op_kinds(
    nodes: typing.Sequence[typing.Dict[str, typing.Any]],
) -> typing.List[str]:
    """Op types in the graph the importer neither folds nor recognizes."""
    kinds = {node["op_type"] for node in nodes}
    return sorted(kinds - _FOLDABLE_OPS - KNOWN_RUNTIME_OPS)


def _diagnose_missing(path, sd: "StateDict", err: KeyError) -> "OnnxParseError":
    """Precise failure for a graph whose params can't be mapped by name."""
    _, nodes = read_onnx_graph(path)
    unknown = unsupported_op_kinds(nodes)
    numeric = sum(1 for k in sd if k.split(".")[0].isdigit() or k.isdigit())
    msg = [f"ONNX import: missing parameter {err.args[0]!r}"]
    if unknown:
        msg.append(f"graph contains unsupported op kinds: {', '.join(unknown)}")
    if numeric > len(sd) // 2:
        msg.append(
            f"{numeric}/{len(sd)} initializers have numeric (constant-folded)"
            " names — re-export with do_constant_folding=False so parameter"
            " names survive"
        )
    return OnnxParseError("; ".join(msg))


def fold_weight_norm_nodes(
    initializers: typing.Dict[str, np.ndarray],
    nodes: typing.Sequence[typing.Dict[str, typing.Any]],
) -> typing.Dict[str, np.ndarray]:
    """Fold in-graph weight-norm subgraphs -> {"<base>.weight": array}."""
    known: typing.Dict[str, np.ndarray] = dict(initializers)
    ancestry: typing.Dict[str, frozenset] = {
        name: frozenset((name,)) for name in initializers
    }
    consumed_by_opaque: typing.Set[str] = set()

    for node in nodes:  # NodeProtos are topologically sorted per ONNX spec
        names = [i for i in node["input"] if i]
        if all(name in known for name in names):
            try:
                out = _eval_node(node, [known[i] if i else None for i in node["input"]])
            except Exception:
                out = None
            if out is not None and node["output"]:
                anc = frozenset().union(*(ancestry[n] for n in names)) if names else frozenset()
                known[node["output"][0]] = out
                ancestry[node["output"][0]] = anc
                continue
        consumed_by_opaque.update(names)

    folded: typing.Dict[str, np.ndarray] = {}
    for out_name, arr in known.items():
        if out_name in initializers:
            continue
        pairs = {
            a[: -len("_g")]
            for a in ancestry[out_name]
            if a.endswith("weight_g")
        }
        vs = {
            a[: -len("_v")]
            for a in ancestry[out_name]
            if a.endswith("weight_v")
        }
        if len(pairs) != 1 or pairs != vs:
            continue
        base = next(iter(pairs))  # "<module>.weight"
        if arr.shape != initializers[base + "_v"].shape:
            continue  # intermediate (norm, reciprocal, ...), not the weight
        # Prefer the tensor an un-foldable consumer (Conv/ConvTranspose)
        # actually reads; otherwise any shape-matching candidate ties and
        # they hold the same value by construction.
        if base not in folded or out_name in consumed_by_opaque:
            folded[base] = arr
    return folded


# --- name normalization + model mapping ---------------------------------------


def _normalize_initializer_names(init: StateDict) -> StateDict:
    """Strip common export prefixes/suffixes so names match state-dict keys."""
    out: StateDict = {}
    for name, array in init.items():
        clean = name
        for prefix in ("model.", "module.", "generator."):
            if clean.startswith(prefix):
                clean = clean[len(prefix) :]
        out[clean] = array
    return out


def onnx_state_dict(path: typing.Union[str, Path]) -> StateDict:
    init, nodes = read_onnx_graph(path)
    sd = {k: np.asarray(v, dtype=v.dtype) for k, v in init.items()}
    # In-graph weight norm: fold to plain weights.  (When the exporter kept
    # the state-dict names, the name-based weight_g/weight_v fold in
    # torch_import covers it too; this also handles the computed tensor.)
    sd.update(fold_weight_norm_nodes(sd, nodes))
    return _normalize_initializer_names(sd)


def glow_tts_params_from_onnx(path: typing.Union[str, Path], cfg: GlowTTSConfig):
    sd = onnx_state_dict(path)
    sd = {k: v.astype(np.float32) if v.dtype == np.float16 else v for k, v in sd.items()}
    try:
        return glow_tts_params_from_state_dict(sd, cfg)
    except KeyError as err:
        raise _diagnose_missing(path, sd, err) from err


def hifi_gan_params_from_onnx(path: typing.Union[str, Path], cfg):
    sd = onnx_state_dict(path)
    sd = {k: v.astype(np.float32) if v.dtype == np.float16 else v for k, v in sd.items()}
    try:
        return hifi_gan_params_from_state_dict(
            sd, cfg.upsample_rates, cfg.resblock_kernel_sizes, resblock=cfg.resblock
        )
    except KeyError as err:
        raise _diagnose_missing(path, sd, err) from err
