"""The port's shared-memory transport (serve/shm.py) against the JAX
package's.

Ring mechanics (reuse, resize to a fresh name, full ring, the size cap,
close unlinks; a ring that is collected or closed unlinks its segments),
the same-host nonce proof, and the orphan sweep, which reclaims the
segment of a creator killed with SIGKILL, spares a live one, and never
touches the other package's segments (the port names its own
"spkn_tshm_<pid>_..."). End to end, over lenet on the CPU: zero tensor
payload bytes on the socket in both directions, answers equal to the
inline wire's bit for bit; a denied or declined handshake falls back
inline; the frontend sweeps orphans at start; a wire-v2 peer gets the
typed bad_version frame. Across packages: a JAX `BinaryClient` with shm
gets an answer from the port's `BinaryFrontend` through segments, and a
port client from the JAX frontend, equal to the inline answers of the
same frontend bit for bit.

Every wait is bounded; nothing depends on thread timing. Each test runs
under prefixes of its own for both packages (`own_prefixes`): a sweep in
another test process (every frontend sweeps at start) reclaims only
segments of the real prefixes, so it can never take this test's planted
orphans, nor this test's sweep another's.
"""
import gc
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve import shm as jax_shm
from sparknet_tpu.serve.binary_frontend import BinaryClient as JaxClient
from sparknet_tpu.serve.binary_frontend import \
    BinaryFrontend as JaxFrontend
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve import shm, wire
from sparknet_tpu_torch.serve.binary_frontend import (BinaryClient,
                                                      BinaryFrontend)
from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBYTES = 28 * 28 * 4
PORT_PREFIX, JAX_PREFIX = shm.SEG_PREFIX, jax_shm.SEG_PREFIX


@pytest.fixture(autouse=True)
def own_prefixes(monkeypatch):
    """Prefixes no other test process sweeps: neither starts with the
    real "spkn_tshm_" or "spkn_shm_"."""
    tag = f"{os.getpid()}x{os.urandom(3).hex()}"
    monkeypatch.setattr(shm, "SEG_PREFIX", f"spkn_tshmtest{tag}")
    monkeypatch.setattr(jax_shm, "SEG_PREFIX", f"spkn_shmtest{tag}")


def _example(i: int) -> dict:
    r = np.random.default_rng(4000 + i)
    return {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}


def _cfg(cls):
    return cls(max_batch=4, max_wait_ms=2.0, outputs=("prob",),
               metrics_every_batches=0)


@pytest.fixture(scope="module")
def net():
    return TorchNet(zoo.lenet(batch=4), seed=3, device="cpu")


@pytest.fixture()
def srv(net):
    with InferenceServer(net, _cfg(ServeConfig)) as s:
        yield s


# -- ring mechanics -----------------------------------------------------------

def test_ring_reuse_resize_full_and_cap():
    ring = shm.ShmRing(n_slots=2, slot_bytes=4096, max_bytes=1 << 20)
    try:
        name1, view1 = ring.acquire(100)
        assert name1.startswith(shm.SEG_PREFIX + f"_{os.getpid()}_")
        view1[:3] = b"abc"
        assert ring.in_flight() == 1
        assert ring.release(name1)
        name2, _ = ring.acquire(100)
        assert name2 == name1  # recycled, not re-created
        ring.release(name2)
        # a payload over the slot size resizes: FRESH generation name,
        # the old name is unknown to release
        name3, view3 = ring.acquire(8192)
        assert name3 != name1 and len(view3) == 8192
        assert not os.path.exists(f"/dev/shm/{name1}")
        assert not ring.release(name1)
        name4, _ = ring.acquire(10)
        assert ring.acquire(10) is None  # both slots in flight: inline
        ring.release(name3)
        ring.release(name4)
        assert ring.acquire((1 << 20) + 1) is None  # over max_bytes
    finally:
        ring.close()
    assert ring.acquire(10) is None  # closed: every acquire is inline


def test_ring_close_unlinks_segments():
    ring = shm.ShmRing(n_slots=1, slot_bytes=4096)
    name, _ = ring.acquire(16)
    assert os.path.exists(f"/dev/shm/{name}")
    ring.release(name)
    ring.close()
    assert not os.path.exists(f"/dev/shm/{name}")
    ring.close()  # twice is harmless


def test_a_collected_ring_unlinks_its_segments():
    """A thread-cached client dies with its thread and nobody calls
    close(): its ring's segments must not stay in /dev/shm."""
    ring = shm.ShmRing(n_slots=2, slot_bytes=4096)
    names = [ring.acquire(16)[0], ring.acquire(16)[0]]
    assert all(os.path.exists(f"/dev/shm/{n}") for n in names)
    del ring
    gc.collect()
    assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)


def test_a_ring_is_unlinked_at_interpreter_exit():
    out = subprocess.run(
        [sys.executable, "-c",
         "from sparknet_tpu_torch.serve import shm\n"
         "ring = shm.ShmRing()\n"
         "print(ring.acquire(64)[0], flush=True)\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    name = out.stdout.strip()
    assert name.startswith(PORT_PREFIX + "_")
    assert not os.path.exists(f"/dev/shm/{name}")
    assert "leaked" not in out.stderr


# -- the same-host proof ------------------------------------------------------

def test_nonce_grants_only_matching_bytes(tmp_path):
    path, nonce = shm.write_nonce(dir=str(tmp_path))
    assert shm.check_nonce(path, nonce)
    assert jax_shm.check_nonce(path, nonce)  # the other package agrees
    assert not shm.check_nonce(path, "not-the-nonce")
    assert not shm.check_nonce(path + ".gone", nonce)
    assert not shm.check_nonce(path, "")
    assert not shm.check_nonce(path, "x" * 300)
    assert oct(os.stat(path).st_mode & 0o777) == "0o600"
    shm.cleanup_nonce(path)
    assert not os.path.exists(path)
    assert not shm.check_nonce(path, nonce)


# -- orphan reclamation -------------------------------------------------------

def _plant(mod, tag):
    """A segment named by `mod`'s prefix under a dead creator pid, left in
    /dev/shm as a SIGKILL leaves it."""
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait(timeout=30)
    name = f"{mod.SEG_PREFIX}_{child.pid}_{tag}_0g1"
    seg = mod._Segment(name=name, create=True, size=4096)
    mod._untrack(name)
    seg.close()
    assert os.path.exists(f"/dev/shm/{name}")
    return name


def test_sweep_reclaims_kill9_orphan_spares_live():
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import os, sys, time\n"
         "from sparknet_tpu_torch.serve import shm\n"
         "seg = shm._Segment(\n"
         "    name=f'{sys.argv[1]}_{os.getpid()}_dead_0g1',\n"
         "    create=True, size=4096)\n"
         "shm._untrack(seg.name)  # a kill -9 takes the tracker too\n"
         "print(seg.name, flush=True)\n"
         "time.sleep(120)\n", shm.SEG_PREFIX],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        orphan = child.stdout.readline().strip()
        assert orphan.startswith(shm.SEG_PREFIX + "_")
        assert os.path.exists(f"/dev/shm/{orphan}")
    finally:
        child.kill()
        child.wait(timeout=10)
        child.stdout.close()
    live = shm.ShmRing(n_slots=1)
    live_name, _ = live.acquire(16)
    try:
        swept = shm.sweep_orphans()
        assert orphan in swept
        assert not os.path.exists(f"/dev/shm/{orphan}")
        assert live_name not in swept
        assert os.path.exists(f"/dev/shm/{live_name}")
    finally:
        live.release(live_name)
        live.close()


def test_each_package_sweeps_only_its_own_segments():
    """The two packages' sweeps run in the same /dev/shm (tests, a mixed
    deployment): each reclaims its own dead segments and leaves the
    other's to the other. The real prefixes never match each other's
    names; under this test's prefixes the sweeps show it."""
    assert not PORT_PREFIX.startswith(JAX_PREFIX + "_")
    assert not JAX_PREFIX.startswith(PORT_PREFIX + "_")
    jax_orphan = _plant(jax_shm, "jaxplant")
    port_orphan = _plant(shm, "portplant")
    try:
        assert shm.sweep_orphans() == [port_orphan]
        assert os.path.exists(f"/dev/shm/{jax_orphan}")
        assert not os.path.exists(f"/dev/shm/{port_orphan}")
        port_again = _plant(shm, "portagain")
        assert jax_shm.sweep_orphans() == [jax_orphan]
        assert os.path.exists(f"/dev/shm/{port_again}")
        assert shm.sweep_orphans() == [port_again]
    finally:
        for n in (jax_orphan, port_orphan):
            if os.path.exists(f"/dev/shm/{n}"):
                os.unlink(f"/dev/shm/{n}")


# -- end to end ---------------------------------------------------------------

def test_shm_transport_zero_socket_payload_both_directions(srv):
    bfe = BinaryFrontend(srv, port=0)
    assert bfe.enable_shm
    cli = BinaryClient(*bfe.address, use_shm=True)
    try:
        assert cli._shm_granted is True
        xs = [_example(i) for i in range(8)]
        outs = [cli.infer(x, model="default", deadline_s=30.0) for x in xs]
        assert cli.payload_tx_bytes == 0 and cli.payload_rx_bytes == 0
        assert bfe.payload_rx_bytes == 0 and bfe.payload_tx_bytes == 0
        # what rode the segments instead: 8 requests' pixels, 8 probs
        assert bfe.shm_rx_bytes == 8 * NBYTES
        assert bfe.shm_tx_bytes == 8 * 10 * 4
        ref = BinaryClient(*bfe.address, use_shm=False)
        try:
            for x, out in zip(xs, outs):
                inline = ref.infer(x, model="default", deadline_s=30.0)
                np.testing.assert_array_equal(out["prob"], inline["prob"])
        finally:
            ref.close()
        qw = cli.last_timing["queue_wait_ms"]
        assert qw is not None and qw >= 0.0
        assert cli._ring.in_flight() == 0  # every slot recycled
        names = list(cli._ring._by_name)
    finally:
        cli.close()
        bfe.stop()
    # the client's request segments and the server's response segments
    # are gone once both ends closed
    assert names and not any(os.path.exists(f"/dev/shm/{n}")
                             for n in names)
    assert not [n for n in os.listdir("/dev/shm")
                if n.startswith(f"{shm.SEG_PREFIX}_{os.getpid()}_")]


def test_shm_denied_by_server_falls_back_inline(srv):
    bfe = BinaryFrontend(srv, port=0, enable_shm=False)
    cli = BinaryClient(*bfe.address, use_shm=True)
    try:
        assert cli._shm_granted is False and cli._ring is None
        out = cli.infer(_example(0), model="default", deadline_s=30.0)
        assert out["prob"].shape == (10,)
        assert cli.payload_tx_bytes == NBYTES
        assert bfe.payload_rx_bytes == NBYTES
        assert cli.payload_rx_bytes > 0
    finally:
        cli.close()
        bfe.stop()


def test_shm_client_optout_never_handshakes(srv):
    bfe = BinaryFrontend(srv, port=0)
    cli = BinaryClient(*bfe.address, use_shm=False)
    try:
        assert cli._shm_granted is None  # no HELLO ever sent
        out = cli.infer(_example(1), model="default", deadline_s=30.0)
        assert out["prob"].shape == (10,)
        assert cli.payload_tx_bytes == NBYTES
    finally:
        cli.close()
        bfe.stop()


def test_frontend_startup_sweeps_orphans(srv):
    name = _plant(shm, "plant")
    bfe = BinaryFrontend(srv, port=0)
    try:
        assert name in bfe.swept_segments
        assert not os.path.exists(f"/dev/shm/{name}")
    finally:
        bfe.stop()


def test_v2_frame_gets_typed_bad_version_with_shm_enabled(srv):
    bfe = BinaryFrontend(srv, port=0)
    assert bfe.enable_shm
    try:
        head, _ = wire.pack_request(1, "default", {})
        s = socket.create_connection(bfe.address, timeout=10)
        s.sendall(head[:4] + bytes([2]) + head[5:])
        s.settimeout(10.0)
        buf = b""
        while len(buf) < wire.HEADER_LEN:
            d = s.recv(4096)
            assert d, "server closed without the typed frame"
            buf += d
        ftype, flags, rid, meta_len, plen = wire.parse_header(buf)
        while len(buf) < wire.HEADER_LEN + meta_len + plen:
            buf += s.recv(4096)
        code, kind, _ = wire.unpack_error_meta(
            buf[wire.HEADER_LEN:wire.HEADER_LEN + meta_len])
        assert ftype == wire.T_ERROR and (code, kind) == (400, "bad_version")
        assert s.recv(4096) == b""
        s.close()
        out = BinaryClient(*bfe.address, use_shm=True)
        try:
            assert out.infer(_example(2), model="default",
                             deadline_s=30.0)["prob"].shape == (10,)
        finally:
            out.close()
    finally:
        bfe.stop()


# -- across packages ----------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_client_port_frontend",
                                       "port_client_jax_frontend"])
def test_shm_across_packages(direction, net):
    """Each package's shm client against the other's frontend: the
    handshake is granted, payloads ride segments (zero socket payload
    bytes on the client), and the answers equal the same frontend's
    inline answers bit for bit."""
    if direction == "jax_client_port_frontend":
        server = InferenceServer(net, _cfg(ServeConfig))
        fe_cls, cli_cls = BinaryFrontend, JaxClient
    else:
        server = JaxServer(JaxNet(jax_zoo.lenet(batch=4), seed=3),
                           _cfg(JaxServeConfig))
        fe_cls, cli_cls = JaxFrontend, BinaryClient
    with server:
        fe = fe_cls(server, port=0)
        cli = cli_cls(*fe.address, use_shm=True)
        ref = cli_cls(*fe.address, use_shm=False)
        try:
            assert cli._shm_granted is True
            for i in range(4):
                x = _example(10 + i)
                got = cli.infer(x, model="default", deadline_s=30.0)
                want = ref.infer(x, model="default", deadline_s=30.0)
                assert got["prob"].shape == (10,)
                np.testing.assert_array_equal(got["prob"], want["prob"])
            assert cli.payload_tx_bytes == 0 and cli.payload_rx_bytes == 0
            assert fe.payload_rx_bytes == 4 * NBYTES  # the inline client's
        finally:
            cli.close()
            ref.close()
            fe.stop()
