"""Weight-only int8 quantization for the serve path.

The counterpart of `sparknet_tpu/model/quant.py`, rewritten without jax.
Per-channel symmetric absmax quantization of the parametric layers'
weight matrices:

    scale[o] = max(|w[..., o]|) / 127        (per output channel)
    w_q[..., o] = round(w[..., o] / scale[o])  in int8

The arithmetic runs in numpy on the JAX package's layouts (Convolution
HWIO, InnerProduct (in, out): the output channel is the LAST axis in
both), with the same operations as the JAX module, so `w_q` and `w_scale`
equal the JAX package's bit for bit. `quant_params_to_port` then carries
them to the port's layouts with the permutations of
`model/net.py:params_from_jax` (conv HWIO -> OIHW, inner product
(in, out) -> (out, in)); `w_scale` stays the 1-D per-output-channel
vector and moves with the output axis, which is axis 0 in the port.

Dequantization happens at use, inside Convolution and InnerProduct
(`model/layers.py:resolve_quantized`): `(w_q.float() * w_scale).to(act)`,
the JAX package's `w_q.astype(f32) * w_scale` cast to the activation
dtype. It is plain PyTorch, as it is an XLA multiply in the JAX package,
not a Pallas kernel. With `act="bfloat16"` (the default) the activations
are bfloat16 from the first quantized layer on, so the LRNs run in
bfloat16 too.

This is a SERVING transform: the serve `ModelManager` quantizes at
checkpoint load time and gates the install on a parity canary against the
f32 forward. Biases stay f32. Quantized layer params look like
`{"w_q": int8, "w_scale": f32[O], "b": f32[O]}` in place of
`{"w": f32, "b": ...}`; the layers dispatch on the `w_q` key, so a params
tree is self-describing and the f32 path is untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

#: layer param trees carrying one of these keys are quantized leaves
QUANT_KEYS = ("w_q", "w_scale")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Knobs for the quantized serve path (ServeConfig.quant surfaces
    these; `mode="int8"` is the only format).

    act: activation dtype for quantized forwards — "bfloat16" (default:
    halves the host->device input bytes and runs the tensor cores'
    bfloat16 path) or "float32" (isolates weight-quant error from
    activation rounding).

    rtol/atol: the parity tolerance the load-time canary enforces between
    the quantized and f32 forwards on the same batch; a quantization whose
    outputs drift past it never serves. The defaults are the JAX
    package's."""

    mode: str = "int8"
    act: str = "bfloat16"
    rtol: float = 0.05
    atol: float = 0.08

    def __post_init__(self) -> None:
        if self.mode != "int8":
            raise ValueError(f"unknown quant mode {self.mode!r}: "
                             f"expected 'int8'")
        if self.act not in ("bfloat16", "float32"):
            raise ValueError(f"unknown quant act dtype {self.act!r}: "
                             f"expected 'bfloat16' or 'float32'")
        if self.rtol < 0 or self.atol < 0:
            raise ValueError("quant rtol/atol must be >= 0")

    def act_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.act == "bfloat16" else torch.float32

    @staticmethod
    def coerce(v: Any) -> Optional["QuantConfig"]:
        """ServeConfig/CLI sugar: None, a mode string ("int8"), a dict of
        fields, or a QuantConfig -> QuantConfig | None."""
        if v is None or isinstance(v, QuantConfig):
            return v
        if isinstance(v, str):
            return QuantConfig(mode=v)
        if isinstance(v, dict):
            return QuantConfig(**v)
        raise ValueError(f"quant must be None, a mode string, a dict, or "
                         f"a QuantConfig (got {type(v).__name__})")


def quantize_leaf(w: np.ndarray) -> Dict[str, np.ndarray]:
    """One weight array in the JAX layout (output channel last) ->
    {"w_q": int8, "w_scale": f32 per output channel}, numpy. The scale
    floor keeps an all-zero channel from dividing by zero."""
    w = np.asarray(w, dtype=np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    scale = np.maximum(absmax / 127.0, np.float32(1e-12)).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {"w_q": q, "w_scale": scale}


def quantize_params(params: Mapping[str, Mapping[str, Any]],
                    cfg: Optional[QuantConfig] = None
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """A params tree in the JAX package's layouts (numpy) -> its
    weight-only-quantized twin, in the same layouts. Every >=2-D "w" leaf
    becomes the (w_q, w_scale) pair; biases and 1-D leaves ride along in
    f32. The input tree is not mutated."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for lname, lp in params.items():
        out[lname] = {}
        for pname, leaf in lp.items():
            if pname == "w" and np.ndim(leaf) >= 2:
                out[lname].update(quantize_leaf(np.asarray(leaf)))
            else:
                out[lname][pname] = np.asarray(leaf)
    return out


def quant_params_to_port(net, qparams: Mapping[str, Mapping[str, Any]],
                         device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A quantized tree in the JAX layouts (`quantize_params`) -> port
    params on `device` for `net` (a CompiledNet): w_q with the weight
    permutations of `params_from_jax`, w_scale and biases as they are
    (both indexed by the output channel)."""
    types = {layer.name: layer.type for layer in net.spec.layers}
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for lname, lp in qparams.items():
        out[lname] = {}
        for pname, leaf in lp.items():
            t = torch.from_numpy(np.array(leaf, order="C"))
            if pname == "w_q" and types[lname] == "Convolution":
                t = t.permute(3, 2, 0, 1)
            elif pname == "w_q" and types[lname] == "InnerProduct":
                t = t.t()
            elif pname != "w_q":
                t = t.to(torch.float32)
            out[lname][pname] = t.contiguous().to(device)
    return out


def is_quantized(params: Mapping[str, Mapping[str, Any]]) -> bool:
    """True when any layer of the tree carries quantized leaves."""
    return any("w_q" in lp for lp in params.values())


def dequantize_weight(w_q: torch.Tensor, w_scale: torch.Tensor
                      ) -> torch.Tensor:
    """w = w_q * w_scale in float32, on the port's layouts (output channel
    on axis 0): the JAX package's `w_q.astype(f32) * w_scale`."""
    return w_q.float() * w_scale.view((-1,) + (1,) * (w_q.ndim - 1))


def dequantize_params(qparams: Mapping[str, Mapping[str, Any]]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The f32 reconstruction (tests / export) of port-layout quantized
    params. NOT the serving path — layers dequantize inside the forward."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for lname, lp in qparams.items():
        out[lname] = {}
        if "w_q" in lp:
            out[lname]["w"] = dequantize_weight(lp["w_q"], lp["w_scale"])
        for pname, leaf in lp.items():
            if pname not in QUANT_KEYS:
                out[lname][pname] = leaf
    return out
