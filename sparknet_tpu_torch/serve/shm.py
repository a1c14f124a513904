"""spkn-shm: the shared-memory local transport for colocated replicas.

The binary wire (wire.py) already made the descriptor table cheap — a
few hundred bytes of header/meta per request. What remains on the hot
LOCAL hop (a router process -> a replica process on the same box) is the
tensor payload itself: every request and response still memcpy's its
bytes INTO the kernel socket path on one side and OUT of it on the
other. For colocated processes that round trip is pure waste —
the bytes never leave the machine.

This module moves the payload into `multiprocessing.shared_memory`
segments: the descriptor table still travels over the socket (framing,
ordering, and error handling stay exactly the wire protocol's), but the
payload bytes are written once into a named segment and read in place by
the peer. Zero tensor bytes through the socket in either direction —
pinned by the frontend's and client's payload byte counters. (The request TRACE
context needs no shm treatment: it is a <50-byte str8 in the REQUEST
meta, so it rides the socket-side descriptor table unchanged and spans
on both ends of an shm hop join the same trace.)

Three pieces:

- `ShmRing`: a per-connection ring of REUSABLE named segments. A sender
  acquires a slot, copies the payload in, names the slot in the frame
  meta (FLAG_SHM), and the receiver maps it by name. Slots are recycled,
  not allocated per request — segment create/unlink is a syscall pair
  that would eat the win at high rps. Request slots are released when
  the terminal reply for the request id arrives (by then the server has
  copied the rows into its bucket buffers); response slots are released
  by an explicit SHM_RELEASE frame once the client has copied the
  tensors out. A full ring (all slots in flight) is not an error: the
  sender falls back to inline payload for that frame.

- The same-host proof: `write_nonce` / `check_nonce`. Before granting
  FLAG_SHM the server must know the client really shares its filesystem
  and memory — a remote peer that happens to guess segment names must
  get inline fallback, not garbage reads. The client writes a random
  nonce to a private temp file and sends (path, nonce) in SHM_HELLO; the
  server grants shm only if reading the path yields the nonce. A remote
  client's path either doesn't exist on the server's filesystem or holds
  different bytes — the handshake degrades to inline transparently.

- `sweep_orphans`: segments survive their creator (that is the point of
  named shm), so a kill -9'd peer leaks its ring in /dev/shm. Every
  segment name embeds its creator pid; the sweep (run at frontend
  startup) unlinks any spkn segment whose pid is dead. A replica
  restarting after a crash cleans up after its predecessor before
  serving a single request.
"""
from __future__ import annotations

import os
import secrets
import tempfile
import threading
import weakref
from typing import Dict, List, Optional, Tuple

try:  # gate: some minimal builds ship Python without _posixshmem
    from multiprocessing import shared_memory as _shm_mod
    from multiprocessing import resource_tracker as _rt
    HAVE_SHM = True
except ImportError:  # pragma: no cover - exercised only on such builds
    _shm_mod = None
    _rt = None
    HAVE_SHM = False

if HAVE_SHM:
    class _Segment(_shm_mod.SharedMemory):
        """SharedMemory whose finalizer tolerates still-exported buffer
        views. A zero-copy tensor view can outlive its connection (the
        batcher's request objects are GC'd lazily); stdlib __del__ then
        sprays BufferError through the GC. The mapping is reclaimed at
        process exit either way — the finalizer must stay quiet."""

        def __del__(self):  # pragma: no cover - GC-timing dependent
            try:
                super().__del__()
            except BufferError:
                pass
else:  # pragma: no cover
    _Segment = None

# the port's own prefix: a sweep in one package never reclaims the other
# package's segments (the JAX package's are "spkn_shm_<pid>_..."); peers
# never need to agree on it, since a frame names its segment in full
SEG_PREFIX = "spkn_tshm"

# segment names THIS process created (rings). An attach of our own
# segment (client and server colocated in one process, e.g. tests) must
# not untrack it — the tracker entry is a set keyed by name, and the
# creator's unlink() still needs it to balance.
_OWNED: set = set()
_owned_lock = threading.Lock()


def shm_available() -> bool:
    """True when the interpreter can create POSIX shared memory."""
    return HAVE_SHM


def _untrack(name: str) -> None:
    """Detach a segment from this process's resource tracker (ATTACHER
    side only). On 3.10 attaching registers the segment exactly like
    creating it, so the first exiting attacher's tracker would unlink
    the mapping out from under every other process. Creators stay
    tracked: their explicit unlink() balances the register, and a
    creator that dies without unlinking gets cleaned by its tracker —
    or, failing that, by `sweep_orphans`. Private API, so best effort:
    a tracker that has changed shape just means noisier exits."""
    try:
        _rt.unregister("/" + name, "shared_memory")
    except Exception:
        pass


def attach(name: str):
    """Map an existing segment by name (receiver side). Raises
    FileNotFoundError if the sender's segment is gone (e.g. swept)."""
    seg = _Segment(name=name, create=False)
    with _owned_lock:
        # a segment this process created — by a ring here, or by the other
        # package's client in the same process (its name embeds our pid) —
        # stays tracked: its creator's unlink() balances the register
        ours = name in _OWNED or f"_{os.getpid()}_" in name
    if not ours:
        _untrack(seg.name)
    return seg


class ShmRing:
    """A ring of reusable named shared-memory segments (one per
    direction per connection). Thread-safe; `acquire` returns None when
    every slot is in flight or the payload exceeds `max_bytes` — the
    caller sends that frame inline and the protocol never blocks on the
    ring."""

    def __init__(self, n_slots: int = 4, slot_bytes: int = 1 << 20,
                 max_bytes: int = 256 << 20):
        self.n_slots = max(1, int(n_slots))
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._uid = secrets.token_hex(4)
        self._gen = 0
        # slot -> (SharedMemory, in_use); grown lazily on first acquire
        self._slots: Dict[int, Tuple[object, bool]] = {}
        self._by_name: Dict[str, int] = {}
        self._init_bytes = max(4096, int(slot_bytes))
        self._closed = False
        # unlinks every segment once: at close(), when the ring is
        # collected (a thread-cached client dies with its thread), or at
        # interpreter exit — a ring never outlives its process in
        # /dev/shm unless the process is killed (then sweep_orphans)
        self._finalize = weakref.finalize(self, _unlink_all, self._slots)

    def _make(self, slot: int, nbytes: int):
        # generation in the name: a resized slot gets a FRESH name, so a
        # peer still holding the old (now unlinked) mapping can never
        # confuse it with the new segment
        self._gen += 1
        name = (f"{SEG_PREFIX}_{os.getpid()}_{self._uid}_"
                f"{slot}g{self._gen}")
        seg = _Segment(name=name, create=True, size=nbytes)
        with _owned_lock:
            _OWNED.add(name)
        return seg

    def acquire(self, nbytes: int) -> Optional[Tuple[str, memoryview]]:
        """A free slot of >= nbytes as (segment name, writable view of
        its first nbytes), or None (ring full / payload too big / ring
        closed) — in which case the caller sends inline."""
        if nbytes > self.max_bytes:
            return None
        nbytes = max(1, int(nbytes))
        with self._lock:
            if self._closed:
                return None
            free = None
            for slot in range(self.n_slots):
                seg, in_use = self._slots.get(slot, (None, False))
                if in_use:
                    continue
                if seg is not None and seg.size >= nbytes:
                    self._slots[slot] = (seg, True)
                    self._by_name[seg.name] = slot
                    return seg.name, seg.buf[:nbytes]
                if free is None:
                    free = slot
            if free is None:
                return None
            old, _ = self._slots.get(free, (None, False))
            if old is not None:
                self._by_name.pop(old.name, None)
                with _owned_lock:
                    _OWNED.discard(old.name)
                # unlink BEFORE close: a still-exported view (a reader
                # mid-copy) makes close() raise BufferError, and the
                # name must come free regardless — the mapping itself
                # is reclaimed when the last view dies
                try:
                    old.unlink()
                except Exception:
                    pass
                try:
                    old.close()
                except Exception:
                    pass
            want = max(self._init_bytes, nbytes)
            seg = self._make(free, want)
            self._slots[free] = (seg, True)
            self._by_name[seg.name] = free
            return seg.name, seg.buf[:nbytes]

    def release(self, name: str) -> bool:
        """Mark the named slot free for reuse. Unknown names are ignored
        (a release can race a resize) — returns whether it hit."""
        with self._lock:
            slot = self._by_name.get(name)
            if slot is None:
                return False
            seg, _ = self._slots[slot]
            self._slots[slot] = (seg, False)
            return True

    def in_flight(self) -> int:
        with self._lock:
            return sum(1 for _, used in self._slots.values() if used)

    def close(self) -> None:
        """Unlink every segment (connection teardown). Peers still
        holding mappings keep valid memory until they close — unlink
        only removes the name."""
        with self._lock:
            self._closed = True
            self._by_name.clear()
        self._finalize()


def _unlink_all(slots: Dict[int, Tuple[object, bool]]) -> None:
    """Unlink and close every segment of a ring's slot table, then empty
    it. Unlink first (see the resize path): the name MUST come free even
    when a peer's view keeps the mapping exported."""
    segs = [seg for seg, _ in slots.values()]
    slots.clear()
    for seg in segs:
        with _owned_lock:
            _OWNED.discard(seg.name)
        try:
            seg.unlink()
        except Exception:
            pass
        try:
            seg.close()
        except Exception:
            pass


# -- the same-host proof ------------------------------------------------------

def write_nonce(dir: Optional[str] = None) -> Tuple[str, str]:
    """Client side of the handshake: (path, nonce). The file is 0600 in
    a fresh private directory — possession of the PATH is not the proof,
    reading the matching BYTES through the server's own filesystem is."""
    d = tempfile.mkdtemp(prefix="spkn-shm-", dir=dir)
    nonce = secrets.token_hex(16)
    path = os.path.join(d, "nonce")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    try:
        os.write(fd, nonce.encode("ascii"))
    finally:
        os.close(fd)
    return path, nonce


def check_nonce(path: str, nonce: str) -> bool:
    """Server side: grant shm only if the client's claimed file really
    holds the claimed nonce ON THIS HOST. Any failure (missing path, a
    remote peer's foreign filesystem, junk) is a quiet False — the
    connection proceeds inline."""
    if not nonce or len(nonce) > 256:
        return False
    try:
        with open(path, "rb") as f:
            return f.read(257).decode("ascii", "replace") == nonce
    except OSError:
        return False


def cleanup_nonce(path: str) -> None:
    """Remove the nonce file + its private dir (client, post-handshake)."""
    try:
        os.unlink(path)
        os.rmdir(os.path.dirname(path))
    except OSError:
        pass


# -- orphan reclamation -------------------------------------------------------

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # alive, someone else's
        return True
    except OSError:
        return False
    return True


def sweep_orphans(shm_dir: str = "/dev/shm") -> List[str]:
    """Unlink every spkn segment whose creator pid is dead (kill -9
    leaves the ring linked in /dev/shm forever otherwise). Run at
    frontend startup, BEFORE any ring exists. Returns the names swept.
    Non-Linux (no /dev/shm listing) is a quiet no-op — segments there
    age out with the OS's own lifecycle."""
    swept: List[str] = []
    if not HAVE_SHM or not os.path.isdir(shm_dir):
        return swept
    prefix = SEG_PREFIX + "_"
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return swept
    for name in names:
        if not name.startswith(prefix):
            continue
        rest = name[len(prefix):].split("_", 1)
        try:
            pid = int(rest[0])
        except (ValueError, IndexError):
            continue
        if _pid_alive(pid):
            continue
        try:
            # attach registers with OUR tracker (3.10); unlink's
            # unregister balances it — no _untrack here
            seg = _Segment(name=name, create=False)
            seg.close()
            seg.unlink()
            swept.append(name)
        except OSError:
            continue
    return swept


def copy_into(view: memoryview, views) -> int:
    """Concatenate payload byte views into a segment view (the sender's
    one copy). Returns bytes written."""
    off = 0
    for v in views:
        n = len(v)
        view[off:off + n] = v
        off += n
    return off
