"""The port's binary frame protocol (serve/wire.py) against the JAX
package's.

Every frame kind is packed by both packages from the same arguments and
must come out byte-equal (header, meta and payload views), so either
package's client talks to the other's frontend; each package then decodes
the other's frames to the same fields. The JAX package's wire unit tests
are repeated on the port's copy: a request round trip, typed bad magic /
version, a truncated meta, and a streamed response whose chunks cover
the payload within the chunk bound.

Inputs are seeded numpy arrays; no tolerance is needed: the wire moves
raw bytes.
"""
import struct

import numpy as np
import pytest

from sparknet_tpu.serve import wire as jax_wire

from sparknet_tpu_torch.serve import wire

PKGS = {"port": wire, "jax": jax_wire}

CONSTANTS = ("MAGIC", "VERSION", "HEADER_LEN", "T_REQUEST", "T_RESPONSE",
             "T_ERROR", "T_CHUNK", "T_CANCEL", "T_SHM_HELLO",
             "T_SHM_RELEASE", "FLAG_STREAM", "FLAG_LAST", "FLAG_SHM")
ERRORS = sorted(n for n in dir(jax_wire) if n.startswith("ERR_"))


def _arrays(seed: int, kinds=("f4", "i4")) -> dict:
    r = np.random.default_rng(seed)
    out = {}
    for i, k in enumerate(kinds):
        shape = (3, 5)[: 1 + i % 2] if i else (4, 3, 2)
        if k == "f4":
            out[f"t{i}"] = r.standard_normal(shape).astype(np.float32)
        elif k == "f2":
            out[f"t{i}"] = r.standard_normal(shape).astype(np.float16)
        elif k == "f8":
            out[f"t{i}"] = r.standard_normal(shape)
        elif k == "u1":
            out[f"t{i}"] = r.integers(0, 255, shape).astype(np.uint8)
        elif k == "b1":
            out[f"t{i}"] = r.integers(0, 2, shape).astype(bool)
        else:
            out[f"t{i}"] = r.integers(-99, 99, shape).astype(np.dtype(k))
    return out


def _flat(head, views) -> bytes:
    return bytes(head) + b"".join(bytes(v) for v in views)


def _items(items) -> bytes:
    return b"".join(bytes(h) + (b"" if v is None else bytes(v))
                    for h, v in items)


@pytest.mark.parametrize("name", CONSTANTS + tuple(ERRORS))
def test_the_protocol_constants_are_the_jax_packages(name):
    assert getattr(wire, name) == getattr(jax_wire, name)


REQUESTS = {
    "plain": dict(),
    "deadline": dict(deadline_ms=125.0),
    "tenant_priority": dict(tenant="t1", priority="low"),
    "stream": dict(stream=True),
    "trace": dict(trace="00000000000000ab-000000cd-1"),
    "shm": dict(shm_seg="spkn_shm_123_abcd_0g1"),
    "everything": dict(deadline_ms=0.5, tenant="hot", priority="high",
                       stream=True, trace="00000000000000ab-000000cd-1"),
}
KINDS = {"f4": ("f4",), "f4_i4": ("f4", "i4"),
         "mixed": ("f2", "f8", "u1", "b1", "i8"), "none": ()}


@pytest.mark.parametrize("kinds", sorted(KINDS))
@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_request_frames_are_byte_equal(case, kinds):
    arrays = _arrays(7, KINDS[kinds])
    got = wire.pack_request(11, "caffenet", arrays, **REQUESTS[case])
    want = jax_wire.pack_request(11, "caffenet", arrays, **REQUESTS[case])
    assert _flat(*got) == _flat(*want)
    # each package decodes the other's frame to the same fields
    buf = _flat(*want)
    _, _, rid, meta_len, _ = wire.parse_header(buf)
    meta = buf[wire.HEADER_LEN:wire.HEADER_LEN + meta_len]
    assert rid == 11
    mine = wire.unpack_request_meta(meta)
    theirs = jax_wire.unpack_request_meta(meta)
    assert mine[:3] == theirs[:3] and mine[4] == theirs[4] \
        and mine[6] == theirs[6]
    assert (mine[3] is None) == (theirs[3] is None)
    assert [(d.name, d.dtype, d.shape, d.offset, d.nbytes)
            for d in mine[5]] == [(d.name, d.dtype, d.shape, d.offset,
                                   d.nbytes) for d in theirs[5]]


RESPONSES = {
    "inline": dict(),
    "queue_wait": dict(queue_wait_ms=3.25),
    "stream_512": dict(stream=True, chunk_bytes=512),
    "stream_default": dict(stream=True),
    "shm": dict(shm_seg="spkn_tshm_9_ffff_1g2", queue_wait_ms=0.0),
}


@pytest.mark.parametrize("step", [None, 0, 7])
@pytest.mark.parametrize("case", sorted(RESPONSES))
def test_response_frames_are_byte_equal(case, step):
    arrays = {"prob": np.linspace(0, 1, 1000, dtype=np.float32),
              "label": np.arange(17, dtype=np.int32)}
    got = wire.pack_response(5, "m", step, arrays, **RESPONSES[case])
    want = jax_wire.pack_response(5, "m", step, arrays, **RESPONSES[case])
    assert len(got) == len(want)
    assert _items(got) == _items(want)
    head = want[0][0]
    meta_len = wire.parse_header(head)[3]
    meta = head[wire.HEADER_LEN:wire.HEADER_LEN + meta_len]
    mine = wire.unpack_response_meta(meta)
    theirs = jax_wire.unpack_response_meta(meta)
    assert mine[0] == theirs[0] == "m" and mine[1] == theirs[1] == step
    assert mine[4] == theirs[4]


@pytest.mark.parametrize("err", ERRORS)
def test_error_frames_are_byte_equal(err):
    got = wire.pack_error(3, getattr(wire, err), "why: ünïcode")
    want = jax_wire.pack_error(3, getattr(jax_wire, err), "why: ünïcode")
    assert got == want
    meta_len = wire.parse_header(got)[3]
    meta = got[wire.HEADER_LEN:wire.HEADER_LEN + meta_len]
    assert wire.unpack_error_meta(meta) == jax_wire.unpack_error_meta(meta)


def test_control_frames_are_byte_equal():
    assert wire.pack_cancel(41) == jax_wire.pack_cancel(41)
    assert wire.pack_shm_hello(2, "/tmp/x/nonce", "ab" * 16) == \
        jax_wire.pack_shm_hello(2, "/tmp/x/nonce", "ab" * 16)
    for ok in (True, False):
        frame = wire.pack_shm_hello_ack(2, ok)
        assert frame == jax_wire.pack_shm_hello_ack(2, ok)
        meta = frame[wire.HEADER_LEN:]
        assert wire.unpack_shm_hello_ack_meta(meta) is ok
    rel = wire.pack_shm_release("spkn_shm_1_2_3g4")
    assert rel == jax_wire.pack_shm_release("spkn_shm_1_2_3g4")
    assert wire.unpack_shm_release_meta(rel[wire.HEADER_LEN:]) == \
        "spkn_shm_1_2_3g4"
    hello = wire.pack_shm_hello(2, "/p", "n")
    assert wire.unpack_shm_hello_meta(hello[wire.HEADER_LEN:]) == \
        ("/p", "n")


# -- the JAX package's wire unit tests, on the port's copy --------------------

def test_wire_request_roundtrip():
    r = np.random.default_rng(0)
    payload = {"data": r.standard_normal((3, 4)).astype(np.float32),
               "label": np.arange(2, dtype=np.int32)}
    head, views = wire.pack_request(7, "m", payload, deadline_ms=125.0,
                                    tenant="t1", priority="low",
                                    stream=True,
                                    trace="00000000000000ab-000000cd-1")
    buf = head + b"".join(bytes(v) for v in views)
    ftype, flags, rid, meta_len, payload_len = wire.parse_header(buf)
    assert (ftype, rid) == (wire.T_REQUEST, 7)
    assert flags & wire.FLAG_STREAM
    meta = buf[wire.HEADER_LEN:wire.HEADER_LEN + meta_len]
    model, tenant, priority, deadline_ms, trace, descs, seg = \
        wire.unpack_request_meta(meta)
    assert seg is None
    assert (model, tenant, priority, deadline_ms) == \
        ("m", "t1", "low", 125.0)
    assert trace == "00000000000000ab-000000cd-1"
    h2, v2 = wire.pack_request(8, "m", payload)
    buf2 = h2 + b"".join(bytes(v) for v in v2)
    meta2_len = wire.parse_header(buf2)[3]
    assert wire.unpack_request_meta(
        buf2[wire.HEADER_LEN:wire.HEADER_LEN + meta2_len])[4] is None
    out = wire.tensors_from(descs, buf[wire.HEADER_LEN + meta_len:])
    assert set(out) == {"data", "label"}
    np.testing.assert_array_equal(out["data"], payload["data"])
    np.testing.assert_array_equal(out["label"], payload["label"])
    assert out["data"].dtype == np.float32
    assert out["label"].dtype == np.int32


def test_wire_bad_magic_and_version_raise_typed():
    head, _ = wire.pack_request(1, "m", {})
    with pytest.raises(wire.WireError, match="magic"):
        wire.parse_header(b"XXXX" + head[4:])
    with pytest.raises(wire.WireError, match="version"):
        wire.parse_header(head[:4] + bytes([99]) + head[5:])
    with pytest.raises(wire.WireError, match="version"):
        wire.parse_header(head[:4] + bytes([wire.VERSION - 1]) + head[5:])


def test_wire_truncated_meta_raises_not_crashes():
    with pytest.raises(wire.WireError, match="truncated"):
        wire.unpack_request_meta(b"\x05ab")  # str8 claims 5, has 2


@pytest.mark.parametrize("chunk", [1, 64, 512, 4096, 1 << 20])
def test_wire_streamed_response_chunks_cover_payload(chunk):
    arrs = {"a": np.arange(1000, dtype=np.float32),
            "b": np.arange(17, dtype=np.int32)}
    items = wire.pack_response(9, "m", 3, arrs, stream=True,
                               chunk_bytes=chunk)
    head0, view0 = items[0]
    ftype, flags, rid, meta_len, total = wire.parse_header(head0)
    assert ftype == wire.T_RESPONSE and flags & wire.FLAG_STREAM
    assert view0 is None and total == 4000 + 68
    buf = bytearray(total)
    saw_last = 0
    for head, view in items[1:]:
        ftype, flags, rid, meta_len, plen = wire.parse_header(head)
        assert ftype == wire.T_CHUNK and rid == 9
        assert plen <= chunk  # the bound the server promises
        off = wire.unpack_chunk_meta(head[wire.HEADER_LEN:])
        buf[off:off + plen] = bytes(view)
        saw_last += bool(flags & wire.FLAG_LAST)
    assert saw_last == 1
    model, step, queue_wait_ms, descs, seg = wire.unpack_response_meta(
        head0[wire.HEADER_LEN:])
    assert (model, step, queue_wait_ms, seg) == ("m", 3, None, None)
    out = wire.tensors_from(descs, bytes(buf))
    np.testing.assert_array_equal(out["a"], arrs["a"])
    np.testing.assert_array_equal(out["b"], arrs["b"])


def test_an_oversized_header_parses_so_the_server_can_answer_it():
    """The 413 analog needs the request id of a frame the server will not
    read: the header alone carries it."""
    hdr = wire.HEADER.pack(wire.MAGIC, wire.VERSION, wire.T_REQUEST, 0, 77,
                           0, (1 << 40))
    assert wire.parse_header(hdr) == (wire.T_REQUEST, 0, 77, 0, 1 << 40)
    assert struct.calcsize("<4sBBHQQQ") == wire.HEADER_LEN == 32
