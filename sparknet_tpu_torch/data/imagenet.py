"""ImageNet-scale sharded-tar ingest.

A copy of `sparknet_tpu/data/imagenet.py` for the port: local shards
through the native plane's member index (or tarfile), and `gs://` /
`s3://` shards through the port's own clients (`data/gcs.py`,
`data/s3.py`) as one streamed ranged GET each, with a per-epoch member
index that is walked again when the object's generation or ETag changes.

Parity with reference `loaders/ImageNetLoader.scala` + `ScaleAndConvert.scala`:
a dataset is a set of tar shards (each holding JPEGs) plus a
`train.txt`-style "filename label" map; workers stream their shards, decode +
force-resize each JPEG to a fixed size, and emit (CHW uint8, label).

Differences by design:
  - shard assignment is by host (`host_shards`): host i of k takes shards
    i::k — the replacement for one-Spark-partition-per-tar.
  - the reference's corrupt-image infinite loop (tar advance only on decode
    success, ImageNetLoader.scala:82-85) is fixed: every entry always
    advances; failures are counted and skipped (`skipped` counter).
  - decode backend: the native C++ data plane (`data.jpeg_plane`) when it
    loads, else PIL (imported when first used). Both produce CHW uint8
    arrays.
"""
from __future__ import annotations

import io
import os
import tarfile
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def load_label_map(path: str) -> Dict[str, int]:
    """Parse 'filename label' lines (reference getLabels, lines 44-57).
    Accepts a local path, a gs:// url, or an s3:// url (the reference read
    its label file from S3 the same way, `ImageNetLoader.scala:44-57`)."""
    from .gcs import gs_read, is_gs_path
    from .s3 import is_s3_path, s3_read
    text = (gs_read(path).decode() if is_gs_path(path)
            else s3_read(path).decode() if is_s3_path(path)
            else open(path).read())
    out: Dict[str, int] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln:
            continue
        name, _, label = ln.rpartition(" ")
        out[name] = int(label)
    return out


def list_shards(root: str, prefix: str = "") -> List[str]:
    """All .tar shard paths under root matching prefix, sorted. gs:// and
    s3:// roots list the bucket natively (HTTP, no FUSE, no SDK — the
    reference listed its S3 bucket per run, `ImageNetLoader.scala:28-41`)."""
    from .gcs import gs_list_shards, is_gs_path
    from .s3 import is_s3_path, s3_list_shards
    if is_gs_path(root):
        return gs_list_shards(root, prefix)
    if is_s3_path(root):
        return s3_list_shards(root, prefix)
    shards = sorted(
        os.path.join(root, f) for f in os.listdir(root)
        if f.startswith(prefix) and f.endswith(".tar"))
    if not shards:
        raise FileNotFoundError(f"no .tar shards under {root!r} "
                                f"matching prefix {prefix!r}")
    return shards


def path_size(path: str, fresh: bool = False) -> int:
    """Byte size of a local file or gs://|s3:// object (shard-weight
    estimates and corpus identity use sizes; bucket sizes come from the
    listing metadata, cached — no extra round trip per shard).
    `fresh=True` bypasses the bucket caches with one metadata request."""
    from .gcs import gs_size, is_gs_path
    from .s3 import is_s3_path, s3_size
    if is_gs_path(path):
        return gs_size(path, fresh=fresh)
    if is_s3_path(path):
        return s3_size(path, fresh=fresh)
    return os.path.getsize(path)


def path_stat(path: str, fresh: bool = False) -> Tuple[int, Optional[str]]:
    """(size, freshness token) — generation for gs://, ETag for s3://,
    None for local files. Both ride the SAME metadata request the
    size-only probe already made, and together they catch what size alone
    cannot: an EQUAL-size replacement of a bucket object (which would
    otherwise be carved at stale member offsets into garbage)."""
    from .gcs import gs_stat, is_gs_path
    from .s3 import is_s3_path, s3_stat
    if is_gs_path(path):
        return gs_stat(path, fresh=fresh)
    if is_s3_path(path):
        return s3_stat(path, fresh=fresh)
    return os.path.getsize(path), None


def _check_tar_terminator(path: str) -> None:
    """Raise TruncatedTarError when a LOCAL tar lacks its zero
    end-of-archive blocks — a shard truncated exactly at a member boundary
    otherwise looks complete to tarfile and trains on partial data. Best
    effort (a member whose data ends in >=1 KiB of zeros could mask a
    missing terminator), which still catches the realistic interrupted-
    copy case the silent path would swallow."""
    from .jpeg_plane import TruncatedTarError
    size = os.path.getsize(path)
    if size < 1024 or size % 512:
        raise TruncatedTarError(f"tar {path!r}: size {size} is not a "
                                f"whole number of 512-byte blocks")
    with open(path, "rb") as f:
        f.seek(size - 1024)
        if f.read(1024).strip(b"\0"):
            raise TruncatedTarError(
                f"tar {path!r} ended without the zero end-of-archive "
                f"block — truncated at a member boundary?")


def _open_tar(path: str) -> tarfile.TarFile:
    """Local shards open seekably; gs://|s3:// shards open as ONE streamed
    ranged GET (`r|` mode) with transparent reconnect-resume — the
    per-task streamed GetObject of the reference
    (`ImageNetLoader.scala:62-63`). Entry-skip on a COLD resume reads
    through the stream (tar offsets of entry N are unknown without an
    index), costing one partial shard download once per restart; once a
    full pass has captured the member index
    (`ShardedTarLoader._bucket_indices`), later epochs and warm resumes
    carve members by (offset, size) and open AT the target byte."""
    from .gcs import gs_open_stream, is_gs_path
    from .s3 import is_s3_path, s3_open_stream
    if is_gs_path(path):
        return tarfile.open(fileobj=gs_open_stream(path), mode="r|*")
    if is_s3_path(path):
        return tarfile.open(fileobj=s3_open_stream(path), mode="r|*")
    return tarfile.open(path, "r")


def host_shards(shards: Sequence[str], host_id: int, host_count: int) -> List[str]:
    return list(shards[host_id::host_count])


def _decode_pil(data: bytes, height: int, width: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(io.BytesIO(data)).convert("RGB")
    img = img.resize((width, height), Image.BILINEAR)  # force-resize
    return np.asarray(img, dtype=np.uint8).transpose(2, 0, 1)  # HWC->CHW


def get_decoder():
    """Prefer the native C++ plane; fall back to PIL."""
    from . import jpeg_plane
    if jpeg_plane.available():
        return jpeg_plane.decode_resize_chw
    return _decode_pil


class ShardedTarLoader:
    """Streams (image CHW uint8, label) pairs from tar shards.

    Reference call shape: `loader.apply(sc, prefix, labelFile, h, w)`
    -> RDD[(Array[Byte], Int)] (ImageNetLoader.scala:93-101).
    """

    def __init__(self, shard_paths: Sequence[str], label_map: Dict[str, int],
                 height: int = 256, width: int = 256):
        self.shard_paths = list(shard_paths)
        self.label_map = label_map
        self.height = height
        self.width = width
        self.skipped = 0  # corrupt/unlabeled entries (counted, never looped on)
        self._tar_indices: Dict[str, object] = {}  # path -> C member index
        #: bucket url -> ([(offset_data, size, isfile, basename)], the
        #: (size, generation|ETag) stat taken before the walk): captured
        #: during the first full tarfile walk; later epochs carve members
        #: from the ranged stream directly
        self._bucket_indices: Dict[str, tuple] = {}
        #: cumulative seconds inside decode calls — wall and calling-thread
        #: CPU
        self.decode_s = 0.0
        self.decode_cpu_s = 0.0
        self._decode = get_decoder()
        self._decode_batch = None
        from . import jpeg_plane
        if jpeg_plane.available():
            self._decode_batch = jpeg_plane.decode_resize_chw_batch

    #: entries buffered per parallel-decode call (native OpenMP batch path)
    DECODE_CHUNK = 128

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        for img, label, _pos in self.iter_with_pos():
            yield img, label

    def iter_with_pos(self, start: Tuple[int, int] = (0, 0)
                      ) -> Iterator[Tuple[np.ndarray, int, Tuple[int, int]]]:
        """Yield (img CHW uint8, label, cursor) where cursor =
        (shard_index, tar entries consumed in that shard) AFTER the entry
        that produced the example. Seeking with `start` skips that many raw
        tar entries WITHOUT decoding."""
        start_shard, start_entry = start
        chunk: List[Tuple[bytes, int, Tuple[int, int]]] = []
        for si in range(start_shard, len(self.shard_paths)):
            skip = start_entry if si == start_shard else 0
            for item in self._shard_entries(si, skip):
                chunk.append(item)
                if len(chunk) >= self.DECODE_CHUNK:
                    yield from self._decode_chunk(chunk)
                    chunk = []
        if chunk:
            yield from self._decode_chunk(chunk)

    def _shard_entries(self, si: int, skip: int
                       ) -> Iterator[Tuple[bytes, int, Tuple[int, int]]]:
        """(jpeg bytes, label, cursor) for labeled file members of shard si
        after the first `skip` members: through the C member index + pread
        when the native plane loads, else tarfile; a bucket shard through
        one ranged stream (tarfile on the first walk, then the member index
        that walk captured). Member numbering is identical on every path."""
        path = self.shard_paths[si]
        idx = self._tar_index(path)
        if idx is not None:
            offsets, sizes, isfile, names = idx
            with open(path, "rb") as f:
                fd = f.fileno()
                for e in range(skip, len(offsets)):
                    if not isfile[e]:
                        continue
                    label = self.label_map.get(names[e])
                    if label is None:
                        self.skipped += 1
                        continue
                    data = os.pread(fd, sizes[e], offsets[e])
                    if len(data) != sizes[e]:
                        # shard truncated since indexing: fail loudly, a
                        # short JPEG would be miscounted as routine decode
                        # corruption and silently skipped
                        raise OSError(
                            f"{path}: short read at member {e + 1} "
                            f"({len(data)} of {sizes[e]} bytes) — shard "
                            f"truncated?")
                    yield data, label, (si, e + 1)
            return
        is_bucket = path.startswith(("gs://", "s3://"))
        if is_bucket:
            cached = self._bucket_indices.get(path)
            if cached is not None:
                bidx, stat_at_capture = cached
                # a replaced object makes the recorded offsets garbage:
                # one fresh metadata request per shard per epoch compares
                # (size, generation|ETag) — the token catches even an
                # EQUAL-size replacement, which size alone cannot — and
                # falls back to the tarfile walk (which re-captures).
                if path_stat(path, fresh=True) != stat_at_capture:
                    del self._bucket_indices[path]
                else:
                    # epoch >= 2 (or post-resume with a warm index):
                    # carve members straight out of ONE ranged stream by
                    # recorded (offset, size) — no tarfile header
                    # parsing, and the stream OPENS at the first needed
                    # byte, so a mid-shard resume skips the prefix
                    # download entirely
                    yield from self._bucket_entries_indexed(path, si,
                                                            skip, bidx)
                    return
        else:
            # tarfile iterates a boundary-truncated archive SILENTLY; the
            # C indexer catches it via the missing terminator, and this
            # closes the same hole on the fallback path (no native plane,
            # extension-header archives). Remote objects are served
            # consistently by the store, so a truncated UPLOAD is the
            # uploader's bug — each ranged read is still length-checked.
            _check_tar_terminator(path)
        # freshness token captured BEFORE the walk: if the object is
        # replaced WHILE we stream it, the index holds old-byte offsets —
        # pairing it with the post-walk stat would make every later
        # epoch's staleness compare pass and carve garbage forever;
        # pairing it with the pre-walk stat makes the next epoch's fresh
        # stat differ and forces a re-walk
        stat_at_walk = path_stat(path, fresh=True) if is_bucket else None
        index = []  # (offset_data, size, isfile, basename) per member
        with _open_tar(path) as tar:
            entry = 0
            for member in tar:  # ALWAYS advances (bug fix vs reference)
                entry += 1
                if is_bucket:
                    index.append((member.offset_data, member.size,
                                  member.isfile(),
                                  os.path.basename(member.name)))
                if entry <= skip or not member.isfile():
                    continue
                name = os.path.basename(member.name)
                label = self.label_map.get(name)
                if label is None:
                    self.skipped += 1
                    continue
                yield tar.extractfile(member).read(), label, (si, entry)
        if is_bucket:
            # cache any walk that REACHED end-of-archive (this code runs
            # only when the member loop exhausted the tar): even a skip>0
            # resume continuation iterated the stream from byte 0 and
            # recorded every member, so its index is complete too — the
            # old `skip == 0` gate made a resumed shard pay one extra
            # full header-parsing walk for nothing. The PRE-walk
            # (size, token) stat rides along for the staleness check.
            self._bucket_indices[path] = (index, stat_at_walk)

    #: forward gaps below this are read-and-discarded on the carve path;
    #: larger ones reopen the ranged stream at the target offset
    BUCKET_REOPEN_GAP = 1 << 20

    def _bucket_entries_indexed(self, path: str, si: int, skip: int, index
                                ) -> Iterator[Tuple[bytes, int,
                                                    Tuple[int, int]]]:
        """Indexed bucket read: one sequential ranged GET per epoch (like
        the tarfile path) but members sliced by recorded (offset, size) —
        the Python tar-header walk the C indexer removed for local shards
        (the JAX package's input-pipeline finding) is gone here too. Short reads fail
        loudly: a shortened member must not decode as routine corruption."""
        from .gcs import gs_open_stream, is_gs_path
        from .s3 import s3_open_stream
        opener = gs_open_stream if is_gs_path(path) else s3_open_stream
        stream, pos = None, 0
        try:
            for e in range(skip, len(index)):
                offset, size, isfile, name = index[e]
                if not isfile:
                    continue
                label = self.label_map.get(name)
                if label is None:
                    self.skipped += 1
                    continue
                if stream is None or offset - pos > self.BUCKET_REOPEN_GAP:
                    if stream is not None:
                        stream.close()
                    stream, pos = opener(path, start=offset), offset
                while pos < offset:  # discard inter-member gap
                    chunk = stream.read(min(offset - pos, 1 << 16))
                    if not chunk:
                        raise IOError(f"{path}: EOF in gap before member "
                                      f"{e + 1} at byte {pos}")
                    pos += len(chunk)
                parts = []
                need = size
                while need:
                    chunk = stream.read(need)
                    if not chunk:
                        raise IOError(
                            f"{path}: short read at member {e + 1} "
                            f"({size - need} of {size} bytes) — object "
                            f"shorter than its index?")
                    parts.append(chunk)
                    need -= len(chunk)
                pos = offset + size
                yield b"".join(parts), label, (si, e + 1)
        finally:
            if stream is not None:
                stream.close()

    def _tar_index(self, path: str):
        """Cached C member index for a LOCAL shard; None -> tarfile path
        (bucket urls, native plane unavailable, or extension headers)."""
        if path in self._tar_indices:
            return self._tar_indices[path]
        from . import jpeg_plane
        idx = None
        if not path.startswith(("gs://", "s3://")) and \
                jpeg_plane.supports_tar_index():
            try:
                idx = jpeg_plane.tar_index(path)
            except jpeg_plane.TruncatedTarError:
                # do NOT fall back: tarfile iterates a boundary-truncated
                # archive silently, which would train on partial data
                raise
            except OSError:
                idx = None
        self._tar_indices[path] = idx
        return idx

    def _decode_chunk(self, chunk: List[Tuple[bytes, int, Tuple[int, int]]]
                      ) -> Iterator[Tuple[np.ndarray, int, Tuple[int, int]]]:
        """Decode a buffered chunk — multi-core via the native OpenMP batch
        kernel when available, else per-image."""
        if self._decode_batch is not None:
            t0, c0 = time.perf_counter(), time.thread_time()
            images, ok = self._decode_batch([c[0] for c in chunk],
                                            self.height, self.width)
            self.decode_s += time.perf_counter() - t0
            self.decode_cpu_s += time.thread_time() - c0
            for i, (_, label, pos) in enumerate(chunk):
                if ok[i]:
                    yield images[i], label, pos
                else:
                    self.skipped += 1  # corrupt image: skip, don't loop
            return
        for data, label, pos in chunk:
            try:
                t0, c0 = time.perf_counter(), time.thread_time()
                img = self._decode(data, self.height, self.width)
                self.decode_s += time.perf_counter() - t0
                self.decode_cpu_s += time.thread_time() - c0
                yield img, label, pos
            except Exception:
                self.skipped += 1  # corrupt image: skip, don't loop

    def load_all(self, limit: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize examples (use for shard-sized chunks). `limit` stops
        DECODING at that many examples — a true RAM cap, not a post-hoc
        slice of a fully decoded corpus."""
        images, labels = [], []
        for img, label in self:
            images.append(img)
            labels.append(label)
            if limit is not None and len(images) >= limit:
                break
        if not images:
            raise ValueError(f"no decodable labeled images in "
                             f"{self.shard_paths}")
        return np.stack(images), np.asarray(labels, np.int32)

    def batches(self, batch_size: int, *, drop_last: bool = True
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Streaming batch iterator: {'data': (B,C,H,W) uint8, 'label': (B,1)}."""
        buf_img: List[np.ndarray] = []
        buf_lbl: List[int] = []
        for img, label in self:
            buf_img.append(img)
            buf_lbl.append(label)
            if len(buf_img) == batch_size:
                yield {"data": np.stack(buf_img),
                       "label": np.asarray(buf_lbl, np.int32)[:, None]}
                buf_img, buf_lbl = [], []
        if buf_img and not drop_last:
            yield {"data": np.stack(buf_img),
                   "label": np.asarray(buf_lbl, np.int32)[:, None]}


def write_synthetic_shards(root: str, n_shards: int = 2, per_shard: int = 8,
                           n_classes: int = 10, size: int = 64,
                           seed: int = 0, corrupt_every: Optional[int] = None,
                           prefix: str = "train") -> str:
    """Build tiny real-JPEG tar shards + label file (for tests and the chip
    smoke): `<prefix>.NNNN.tar` and `<prefix>.txt`. Returns the label file
    path. corrupt_every=k injects a truncated JPEG at every k-th entry
    (exercising the skip path). PIL is imported when called."""
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    r = np.random.default_rng(seed)
    label_lines = []
    count = 0
    for s in range(n_shards):
        tar_path = os.path.join(root, f"{prefix}.{s:04d}.tar")
        with tarfile.open(tar_path, "w") as tar:
            for i in range(per_shard):
                name = f"img_{s}_{i}.JPEG"
                arr = r.integers(0, 256, (size, size, 3), dtype=np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG")
                data = buf.getvalue()
                count += 1
                if corrupt_every and count % corrupt_every == 0:
                    data = data[: len(data) // 2]  # truncated -> decode error
                info = tarfile.TarInfo(name=name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
                label_lines.append(f"{name} {int(r.integers(0, n_classes))}")
    label_path = os.path.join(root, f"{prefix}.txt")
    with open(label_path, "w") as f:
        f.write("\n".join(label_lines) + "\n")
    return label_path
