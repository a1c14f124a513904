"""Caffe prototxt (protobuf text-format) importer.

A copy of `sparknet_tpu/model/prototxt.py` (pure Python; it imports only
`.spec`), so that the port never imports the JAX package.

Parity with the reference's native prototxt path
(`ReadProtoFromTextFileOrDie` at reference `apps/CifarApp.scala:83-84`,
`libs/CaffeNet.scala:22-26`): parse the text format into a generic message
tree, then interpret the NetParameter / SolverParameter subset used by the
reference model zoo (`models/cifar10/*.prototxt`,
`models/bvlc_reference_caffenet/*.prototxt`, `models/adult/adult.prototxt`)
into `NetSpec` / a solver-config dict.

The parser is a small hand-rolled recursive-descent tokenizer: no protobuf
runtime or compiled descriptors needed, and it accepts any well-formed
text-format message (unknown fields are preserved in the generic tree and
ignored by the interpreters).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple, Union

from .spec import (
    AccuracyParam,
    ConvolutionParam,
    DropoutParam,
    Filler,
    InnerProductParam,
    InputSpec,
    LayerSpec,
    LRNParam,
    NetSpec,
    ParamSpec,
    PoolingParam,
    validate,
)

# ---------------------------------------------------------------------------
# Generic text-format parsing
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<punct>[{}:])
      | (?P<atom>[^\s{}:"#]+)
    )
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[str]:
    tokens: List[str] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise ValueError(f"prototxt: unexpected character at offset {pos}: "
                             f"{text[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        tokens.append(m.group(m.lastgroup))
    return tokens


Message = Dict[str, List[Any]]  # field name -> list of values (scalars or sub-messages)


def _coerce_scalar(tok: str) -> Union[str, int, float, bool]:
    if tok.startswith('"'):
        return tok[1:-1].encode().decode("unicode_escape")
    if tok == "true":
        return True
    if tok == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum identifier (e.g. MAX, AVE, TRAIN)


def parse_message(text: str) -> Message:
    """Parse protobuf text-format into a dict of field -> list of values."""
    tokens = _tokenize(text)
    pos = 0

    def parse_body(stop_at_brace: bool) -> Message:
        nonlocal pos
        msg: Message = {}
        while pos < len(tokens):
            tok = tokens[pos]
            if tok == "}":
                if not stop_at_brace:
                    raise ValueError("prototxt: unbalanced '}'")
                pos += 1
                return msg
            field = tok
            pos += 1
            if pos >= len(tokens):
                raise ValueError(f"prototxt: dangling field {field!r}")
            if tokens[pos] == ":":
                pos += 1
                if pos < len(tokens) and tokens[pos] == "{":
                    # `field: { ... }` is also legal text format
                    pos += 1
                    value: Any = parse_body(True)
                else:
                    value = _coerce_scalar(tokens[pos])
                    pos += 1
            elif tokens[pos] == "{":
                pos += 1
                value = parse_body(True)
            else:
                raise ValueError(
                    f"prototxt: expected ':' or '{{' after field {field!r}, "
                    f"got {tokens[pos]!r}")
            msg.setdefault(field, []).append(value)
        if stop_at_brace:
            raise ValueError("prototxt: missing '}'")
        return msg

    return parse_body(False)


def _one(msg: Message, field: str, default=None):
    vals = msg.get(field)
    if not vals:
        return default
    return vals[-1]  # text-format: last occurrence of a singular field wins


# ---------------------------------------------------------------------------
# NetParameter interpretation
# ---------------------------------------------------------------------------


def _filler(msg: Message | None) -> Filler:
    if not msg:
        return Filler()
    return Filler(
        type=_one(msg, "type", "constant"),
        value=float(_one(msg, "value", 0.0)),
        std=float(_one(msg, "std", 0.01)),
        mean=float(_one(msg, "mean", 0.0)),
        min=float(_one(msg, "min", 0.0)),
        max=float(_one(msg, "max", 1.0)),
    )


def _square_geometry(block: "Message", layer_name: str, block_name: str,
                     base: str, default: int) -> int:
    """Resolve `<base>` vs `<base>_h`/`<base>_w` (Caffe allows either form).
    Square h==w values fold into the base field; genuinely RECTANGULAR
    geometry fails loudly — importing it with defaults would train a
    structurally wrong net (same stance as unknown layer types and non-SGD
    solvers)."""
    bv = _one(block, base)
    stem = base[:-5] if base.endswith("_size") else base  # kernel_size -> kernel_h
    hv, wv = _one(block, f"{stem}_h"), _one(block, f"{stem}_w")
    if hv is None and wv is None:
        return int(bv) if bv is not None else default
    if hv is None or wv is None or int(hv) != int(wv):
        raise ValueError(
            f"layer {layer_name!r}: {block_name} {stem}_h/{stem}_w = "
            f"({hv}, {wv}) is rectangular — recognized but not implemented "
            f"(square geometry only); refusing to import a structurally "
            f"different net silently")
    if bv is not None and int(bv) != int(hv):
        raise ValueError(
            f"layer {layer_name!r}: {block_name} specifies both {base}={bv} "
            f"and {base}_h/{base}_w={hv} with conflicting values")
    return int(hv)


def _layer_from_msg(m: Message) -> LayerSpec:
    name = _one(m, "name", "")
    ltype = _one(m, "type", "")
    bottoms = tuple(m.get("bottom", []))
    tops = tuple(m.get("top", []))
    params = tuple(
        ParamSpec(
            lr_mult=float(_one(p, "lr_mult", 1.0)),
            decay_mult=float(_one(p, "decay_mult", 1.0)),
        )
        for p in m.get("param", [])
    )
    include_phase = None
    for inc in m.get("include", []):
        phase = _one(inc, "phase")
        if phase is not None:
            include_phase = str(phase)

    kw: Dict[str, Any] = {}
    cp = _one(m, "convolution_param")
    if cp:
        if int(_one(cp, "dilation", 1)) != 1:
            raise ValueError(
                f"layer {name!r}: convolution_param.dilation is recognized "
                f"but not implemented — refusing to import a structurally "
                f"different net silently")
        kw["conv"] = ConvolutionParam(
            num_output=int(_one(cp, "num_output", 0)),
            kernel_size=_square_geometry(cp, name, "convolution_param",
                                         "kernel_size", 1),
            stride=_square_geometry(cp, name, "convolution_param",
                                    "stride", 1),
            pad=_square_geometry(cp, name, "convolution_param", "pad", 0),
            group=int(_one(cp, "group", 1)),
            bias_term=bool(_one(cp, "bias_term", True)),
            weight_filler=_filler(_one(cp, "weight_filler")),
            bias_filler=_filler(_one(cp, "bias_filler")),
        )
    pp = _one(m, "pooling_param")
    if pp:
        kw["pool"] = PoolingParam(
            pool=str(_one(pp, "pool", "MAX")),
            kernel_size=_square_geometry(pp, name, "pooling_param",
                                         "kernel_size", 1),
            stride=_square_geometry(pp, name, "pooling_param", "stride", 1),
            pad=_square_geometry(pp, name, "pooling_param", "pad", 0),
            global_pooling=bool(_one(pp, "global_pooling", False)),
        )
    lp = _one(m, "lrn_param")
    if lp:
        kw["lrn"] = LRNParam(
            local_size=int(_one(lp, "local_size", 5)),
            alpha=float(_one(lp, "alpha", 1.0)),
            beta=float(_one(lp, "beta", 0.75)),
            k=float(_one(lp, "k", 1.0)),
            norm_region=str(_one(lp, "norm_region", "ACROSS_CHANNELS")),
        )
    ip = _one(m, "inner_product_param")
    if ip:
        kw["inner_product"] = InnerProductParam(
            num_output=int(_one(ip, "num_output", 0)),
            bias_term=bool(_one(ip, "bias_term", True)),
            weight_filler=_filler(_one(ip, "weight_filler")),
            bias_filler=_filler(_one(ip, "bias_filler")),
        )
    dp = _one(m, "dropout_param")
    if dp:
        kw["dropout"] = DropoutParam(
            dropout_ratio=float(_one(dp, "dropout_ratio", 0.5)))
    ap = _one(m, "accuracy_param")
    if ap:
        kw["accuracy"] = AccuracyParam(top_k=int(_one(ap, "top_k", 1)))
    if ltype == "Dropout" and "dropout" not in kw:
        kw["dropout"] = DropoutParam()
    if ltype == "Accuracy" and "accuracy" not in kw:
        kw["accuracy"] = AccuracyParam()
    ccp = _one(m, "concat_param")
    if ccp:
        axis = _one(ccp, "axis", _one(ccp, "concat_dim", 1))
        if int(axis) != 1:
            raise ValueError(
                f"layer {name!r}: Concat axis {axis} is recognized but only "
                f"channel concat (axis 1) is implemented — refusing to "
                f"import a structurally different net silently")

    return LayerSpec(
        name=name,
        type=ltype,
        bottoms=bottoms,
        tops=tops,
        params=params,
        include_phase=include_phase,
        **kw,
    )


_SKIP_LAYER_TYPES = {"Data", "ImageData", "HDF5Data"}  # data layers -> net inputs


def net_from_prototxt(text: str) -> NetSpec:
    """Interpret a NetParameter text proto into a NetSpec.

    Handles both in-memory input declarations (`input:` + `input_shape`, as in
    the reference's cifar10/adult prototxts) and `Data`-type layers (as in
    bvlc_reference_caffenet/train_val.prototxt), which become declared inputs
    since this framework feeds batches directly.
    """
    msg = parse_message(text)
    name = _one(msg, "name", "net")

    inputs: List[InputSpec] = []
    input_names = list(msg.get("input", []))
    shapes = msg.get("input_shape", [])
    # legacy `input_dim` flat form: 4 dims per input
    flat_dims = [int(d) for d in msg.get("input_dim", [])]
    for i, iname in enumerate(input_names):
        if i < len(shapes):
            dims = tuple(int(d) for d in shapes[i].get("dim", []))
        elif flat_dims:
            dims = tuple(flat_dims[i * 4:(i + 1) * 4])
        else:
            raise ValueError(f"input {iname!r} has no declared shape")
        dtype = "int32" if iname == "label" else "float32"
        inputs.append(InputSpec(name=iname, shape=dims, dtype=dtype))

    layers: List[LayerSpec] = []
    for lm in msg.get("layer", []) + msg.get("layers", []):
        spec = _layer_from_msg(lm)
        if spec.type in _SKIP_LAYER_TYPES:
            # Data layer: its tops become net inputs. Shape is unknown from the
            # prototxt alone (lives in transform_param / data source); callers
            # pass shapes via `data_layer_shapes`.
            for top in spec.tops:
                if top not in [i.name for i in inputs]:
                    dtype = "int32" if top == "label" else "float32"
                    inputs.append(InputSpec(name=top, shape=(), dtype=dtype))
            continue
        layers.append(spec)

    spec = NetSpec(name=name, inputs=tuple(inputs), layers=tuple(layers))
    return spec


def net_from_prototxt_file(path: str, *,
                           input_shapes: Dict[str, Tuple[int, ...]] | None = None,
                           phase: str | None = None) -> NetSpec:
    with open(path) as f:
        spec = net_from_prototxt(f.read())
    if input_shapes:
        new_inputs = tuple(
            InputSpec(i.name, tuple(input_shapes.get(i.name, i.shape)), i.dtype)
            for i in spec.inputs)
        spec = spec.replace(inputs=new_inputs)
    missing = [i.name for i in spec.inputs if not i.shape]
    if missing:
        raise ValueError(
            f"net {spec.name!r}: inputs {missing} need shapes "
            f"(pass input_shapes=...)")
    if phase is not None:
        spec = spec.replace(layers=tuple(spec.layers_for_phase(phase)))
    validate(spec)
    return spec


# ---------------------------------------------------------------------------
# SolverParameter interpretation
# ---------------------------------------------------------------------------


def solver_from_prototxt(text: str) -> Dict[str, Any]:
    """Parse a SolverParameter text proto into a plain config dict.

    Covers the fields the reference solvers use
    (`models/cifar10/cifar10_quick_solver.prototxt:12-20`,
    `models/bvlc_reference_caffenet/solver.prototxt:2-11`):
    base_lr, momentum, weight_decay, lr_policy, gamma, stepsize, power,
    max_iter, display, snapshot, net.
    """
    msg = parse_message(text)
    out: Dict[str, Any] = {}
    for key in ("base_lr", "momentum", "weight_decay", "gamma", "power"):
        v = _one(msg, key)
        if v is not None:
            out[key] = float(v)
    for key in ("stepsize", "max_iter", "display", "snapshot", "iter_size"):
        v = _one(msg, key)
        if v is not None:
            out[key] = int(v)
    for key in ("lr_policy", "net", "snapshot_prefix", "type", "solver_mode"):
        v = _one(msg, key)
        if v is not None:
            out[key] = str(v)
    if "stepvalue" in msg:
        out["stepvalue"] = [int(v) for v in msg["stepvalue"]]
    return out


def solver_from_prototxt_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return solver_from_prototxt(f.read())
