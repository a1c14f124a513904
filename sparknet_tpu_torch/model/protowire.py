"""Protobuf wire-format decoding (generic): the two helpers the `.caffemodel`
reader uses.

A copy of `_read_varint` and `parse_wire` from
`sparknet_tpu/backend/tf_import.py`. The port has no graph backend yet, and
that module imports jax through `backend/graphdef.py`, so the port keeps
its own copy here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def parse_wire(buf: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Decode one message into {field_number: [(wire_type, raw_value), ...]}."""
    fields: Dict[int, List[Tuple[int, Any]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")
        fields.setdefault(fno, []).append((wt, val))
    return fields
