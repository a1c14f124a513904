"""Streaming round source: train from tar shards larger than host RAM.

The port's copy of `sparknet_tpu/data/streaming.py`, over the port's
`ShardedTarLoader`. In the port one process drives one card, so the
ImageNet app builds a rank's source with one worker over that rank's
readers (`apps/imagenet_app.py`: the topology).

The reference never materialized ImageNet — each Spark task streamed its tar
and trained on what it read (`loaders/ImageNetLoader.scala:59-91`, one
partition per tar). This is that data motion, mesh-native: a background
thread streams + decodes this HOST's shards (via `ShardedTarLoader`, which
already fans decode out over OpenMP) and assembles τ-round batch arrays into
a bounded queue, so round R+1's window is decoded while round R trains on
device. Host RAM holds only `prefetch_rounds + 1` rounds of decoded pixels,
never the corpus.

Semantics vs the in-RAM `RoundSampler`:
  - windows are consecutive stream positions, not random offsets into a
    cached partition — exactly the reference's behavior for its streamed
    (non-cached) datasets; shards cycle forever (epoch boundaries are
    invisible, like the reference's `.repeat()`-style requeue).
  - `round_index` is accepted for API compatibility but does not key the
    sampling: position is a STREAM CURSOR. The source reports the cursor
    after each consumed round (`cursor`/`epochs`, updated by `next_round`),
    the training loop persists it in the checkpoint, and a resumed source
    (`start_cursor=`/`start_epochs=`) seeks — skipping raw tar entries
    without decoding — instead of re-streaming from shard 0 (the reference
    had no resume at all; SURVEY §5.3).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .imagenet import ShardedTarLoader


def _split_loaders(shard_paths, label_map, n_sources: int, height: int,
                   width: int, cls=ShardedTarLoader) -> list:
    """THE reader fan-out invariant, in one place: N clamped to the shard
    count, reader j takes shards j::N (the same i::k mechanism
    `imagenet.host_shards` uses across hosts). Shared by the parallel
    round source and the parallel mean pass so the split cannot drift."""
    n = max(1, min(int(n_sources), len(shard_paths)))
    return [cls(list(shard_paths[j::n]), label_map,
                height=height, width=width) for j in range(n)]


def streaming_sum_count(loader: ShardedTarLoader, workers: int = 1
                        ) -> Tuple[np.ndarray, int]:
    """One streaming pass over the shards -> (per-pixel float64 sum CHW,
    count). The mean-image reduce (`ImageNetApp.scala:66-69`) without ever
    materializing the corpus; hosts combine (sum, count) pairs for the
    global mean.

    `workers` > 1 fans the pass out over shard subsets j::N in threads
    (decode and pread release the GIL): on real ImageNet this one-time
    pass decodes the host's whole corpus, which at a single reader's rate
    is tens of minutes a 40-core host spends 97% idle. Partial sums are
    float64, and the per-subset partials are reduced in a fixed (subset-
    index) order, so the result is deterministic for a given worker
    count; it equals the serial pass up to float64 summation order (~1
    ulp on uint8-sourced pixels), not bit-for-bit, since grouping
    additions by subset reorders them."""

    def one(sub: ShardedTarLoader) -> Tuple[Optional[np.ndarray], int]:
        total: Optional[np.ndarray] = None
        count = 0
        for img, _ in sub:
            if total is None:
                total = np.zeros(img.shape, np.float64)
            total += img
            count += 1
        return total, count

    subs = _split_loaders(loader.shard_paths, loader.label_map, workers,
                          loader.height, loader.width, cls=type(loader))
    n = len(subs)
    if n == 1:
        total, count = one(loader)
    else:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(n, thread_name_prefix="mean-pass") as pool:
            parts = list(pool.map(one, subs))
        for sub in subs:
            loader.skipped += sub.skipped
            # keep the shared loader's C member-index cache warm: the
            # training stream reuses this loader (ingest_sources=1) and
            # would otherwise re-walk every tar's headers
            loader._tar_indices.update(sub._tar_indices)
        total, count = None, 0
        for t, c in parts:
            if t is not None:
                total = t if total is None else total + t
                count += c
    if count == 0:
        raise ValueError(f"no decodable labeled images in "
                         f"{loader.shard_paths}")
    return total, count


class StreamingRoundSource:
    """Bounded-prefetch producer of τ-round batches from tar shards.

    `next_round()` returns the same layout `RoundSampler.next_round` does —
    {field: [tau, n_workers*local_batch, ...]} with the batch axis blocked by
    worker, each worker's block a consecutive run of tau*local_batch stream
    examples (its "window"). Raw uint8 CHW + int32 labels; per-round
    preprocessing (mean/crop/NHWC) stays in the training loop.

    The producer thread starts lazily on the first `next_round()`, so a
    source can be constructed, then positioned from a checkpoint
    (`start_cursor`/`start_epochs` at construction) before any decode work
    happens. After each `next_round()`, `cursor` is the (shard_index,
    entries_consumed_in_shard) position after that round's last example and
    `epochs` the completed shard-set passes — exactly what a checkpoint
    taken now must record to resume the stream.
    """

    def __init__(self, loader: ShardedTarLoader, n_workers: int,
                 local_batch: int, tau: int, prefetch_rounds: int = 2,
                 start_cursor: Tuple[int, int] = (0, 0),
                 start_epochs: int = 0):
        self.loader = loader
        self.n_workers = n_workers
        self.local_batch = local_batch
        self.tau = tau
        self.round_examples = n_workers * local_batch * tau
        #: position after the last round handed to the consumer
        self.cursor: Tuple[int, int] = tuple(start_cursor)
        #: completed passes over the shard set at that position
        self.epochs = int(start_epochs)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch_rounds))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._round_cursors: Dict[int, Tuple[Tuple[int, int], int]] = {}

    def _ensure_started(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._produce, name="stream-decode", daemon=True)
            self._thread.start()

    # -- producer (background thread) ---------------------------------------

    def _produce(self) -> None:
        try:
            w, b, t = self.n_workers, self.local_batch, self.tau
            data = label = None
            count = 0
            cursor = self.cursor
            epochs = self.epochs
            seeked = cursor != (0, 0)
            while not self._stop.is_set():
                n_before = 0
                for img, lbl, pos in self.loader.iter_with_pos(cursor):
                    n_before += 1
                    if data is None:
                        # round layout: [tau, W*B, ...] with the batch axis
                        # blocked by worker, each worker's block a
                        # consecutive tau*b stream run. Write each image
                        # straight into its slot — ONE copy per image
                        # (stack+transpose+contiguous cost 3x the bytes)
                        data = np.empty((t, w * b) + img.shape, img.dtype)
                        label = np.empty((t, w * b, 1), np.int32)
                    wk, rem = divmod(count, t * b)
                    tt, j = divmod(rem, b)
                    data[tt, wk * b + j] = img
                    label[tt, wk * b + j, 0] = lbl
                    count += 1
                    if count == self.round_examples:
                        item = ({"data": data, "label": label}, pos, epochs)
                        if not self._put(item):
                            return
                        data = label = None  # handed off; fresh buffers
                        count = 0
                    if self._stop.is_set():
                        return
                if n_before == 0 and not seeked:
                    # a full from-the-start pass produced nothing: the
                    # shards are empty/corrupt. (A seeked first pass may
                    # legitimately be empty — cursor at the stream's end.)
                    raise ValueError(
                        f"no decodable labeled images in "
                        f"{self.loader.shard_paths}")
                cursor = (0, 0)  # wrap: stream the shards again
                seeked = False
                epochs += 1
        except BaseException as e:  # surface in the consumer
            self._err = e
            self._stop.set()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer ------------------------------------------------------------

    def seek(self, cursor: Tuple[int, int], epochs: int = 0) -> None:
        """Position the stream from a checkpoint. Only valid before the
        first `next_round()` (the producer starts lazily)."""
        if self._thread is not None:
            raise RuntimeError("seek() after streaming started — construct "
                               "a fresh source or seek before next_round()")
        self.cursor = (int(cursor[0]), int(cursor[1]))
        self.epochs = int(epochs)

    def seek_rows(self, rows) -> bool:
        """Uniform resume protocol shared with ParallelStreamingSource:
        `rows` is [[shard, entry, epochs], ...], one row per reader. A
        single-reader source can only honor a single-reader checkpoint —
        a source-count change reassigned the shards, so old cursors are
        meaningless and the caller restarts the stream (returns False)."""
        if len(rows) != 1:
            return False
        self.seek((rows[0][0], rows[0][1]), rows[0][2])
        return True

    def next_round(self, round_index: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        self._ensure_started()
        while True:
            if self._err is not None:
                raise RuntimeError("streaming decode thread failed") \
                    from self._err
            try:
                batches, self.cursor, self.epochs = self._q.get(timeout=0.1)
                if round_index is not None:
                    # cursor keyed by the round it feeds: the training
                    # loop's one-deep prefetch fetches round R+1 while R
                    # trains, so "the source's current cursor" at
                    # checkpoint time is one round AHEAD of the trained
                    # state — checkpoints ask for cursor_at(trained round)
                    self._round_cursors[round_index] = (self.cursor,
                                                        self.epochs)
                    for k in [k for k in self._round_cursors
                              if k < round_index - 4]:
                        del self._round_cursors[k]
                return batches
            except queue.Empty:
                if self._stop.is_set() and self._err is None:
                    raise RuntimeError("streaming source closed")

    def cursor_at(self, round_index: int
                  ) -> Optional[Tuple[Tuple[int, int], int]]:
        """((shard, entry), epochs) after the round that carried this
        index, if still retained — what a checkpoint taken after training
        that round must record."""
        return self._round_cursors.get(round_index)

    @property
    def skipped(self) -> int:
        return self.loader.skipped

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked producer put() sees the stop promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "StreamingRoundSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _RingSlot:
    """One in-flight round buffer: producers write disjoint blocks, the
    consumer takes it when all producers have finished theirs."""

    __slots__ = ("round", "done", "ready", "data", "label", "cursors")

    def __init__(self, round_index: int, n_sources: int):
        self.round = round_index
        self.done = 0
        self.ready = False
        self.data = None
        self.label = None
        self.cursors = [None] * n_sources


class ParallelStreamingSource:
    """N concurrent shard readers feeding one round stream, past the
    throughput ceiling of a single source.

    One `StreamingRoundSource` runs a single producer thread: decode fans
    out over OpenMP, but the tar read + round-buffer write residue is
    serial, capping any single source at ~1/residue img/s no matter how
    many cores the host has (PERF.md input-pipeline scaling model). The
    reference had no such ceiling — it ran one Spark task per tar chunk
    (`loaders/ImageNetLoader.scala:28-41`), so the whole corpus decoded in
    parallel across every executor core. This class is that corpus-wide
    parallelism per host: reader j streams loaders[j] (the host's shards
    j::N via `imagenet.host_shards`-style splitting) and writes its block
    of each round DIRECTLY into a shared ring of round buffers — no
    assembly copy, no global serial stage; the per-round serial work on
    any one thread divides by N.

    Round layout is identical to `StreamingRoundSource.next_round`:
    {field: [tau, n_workers*local_batch, ...]}, batch axis blocked by
    worker. The round's linear example index c maps to slot
    (c//(tau*b), c%(tau*b)); reader j owns c in [j*block, (j+1)*block)
    with block = round_examples/N — contiguous stream runs per reader, and
    when N == n_workers each worker's window is exactly one reader's
    stream (the reference's partition-per-worker shape).

    Resume: each reader has an independent (shard, entry) cursor + epoch
    counter over ITS shard subset; `cursor_at(round)` returns all N
    (cursor, epochs) pairs and `seek_rows` repositions all N — the
    checkpoint carries one row per reader per host. A checkpoint taken
    with a different reader count cannot be honored (the shard assignment
    itself changed): seek_rows returns False and the caller restarts the
    stream, same policy as a host-count change.
    """

    def __init__(self, loaders, n_workers: int, local_batch: int, tau: int,
                 prefetch_rounds: int = 2):
        if not loaders:
            raise ValueError("need at least one loader")
        for i, ld in enumerate(loaders):
            if not ld.shard_paths:
                raise ValueError(
                    f"reader {i} of {len(loaders)} has no shards — use "
                    f"fewer sources than shards (shards split j::N)")
        self.loaders = list(loaders)
        self.n_sources = len(loaders)
        self.n_workers = n_workers
        self.local_batch = local_batch
        self.tau = tau
        self.round_examples = n_workers * local_batch * tau
        if self.round_examples % self.n_sources:
            raise ValueError(
                f"round examples {self.round_examples} "
                f"(= {n_workers} workers x {local_batch} batch x {tau} tau) "
                f"not divisible by {self.n_sources} sources")
        self.block = self.round_examples // self.n_sources
        self._K = max(2, prefetch_rounds + 1)
        self._ring = [_RingSlot(i, self.n_sources) for i in range(self._K)]
        self._next_out = 0  # next round index the consumer takes
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._threads: Optional[list] = None
        self._start = [((0, 0), 0)] * self.n_sources
        #: per-reader cursors after the last consumed round
        self.cursors = list(self._start)
        self._round_cursors: Dict[int, list] = {}
        #: per-reader {'busy_cpu_s','wait_s','images'}; see source_stats()
        self.stats = [{"busy_cpu_s": 0.0, "wait_s": 0.0, "images": 0}
                      for _ in range(self.n_sources)]

    def source_stats(self) -> list:
        """Per-reader stage accounting: busy_cpu_s (the reader thread's CPU
        time outside ring waits), decode_cpu_s (its CPU share of decode —
        the OpenMP-parallel stage), serial_s = busy_cpu - decode_cpu (tar
        read + buffer write + glue — the per-reader SERIAL residue whose
        division by N is this class's whole point), wait_s (ring
        backpressure, wall), images. CPU clocks, not wall: a thread
        descheduled behind the GIL or a busy core accrues none, so the
        accounting holds on any core count (a wall clock on a contended
        host charges every reader for its neighbors' work)."""
        out = []
        for j, st in enumerate(self.stats):
            d = dict(st)
            d["decode_cpu_s"] = self.loaders[j].decode_cpu_s
            d["serial_s"] = max(0.0, d["busy_cpu_s"] - d["decode_cpu_s"])
            out.append(d)
        return out

    # -- producers (one thread per reader) -----------------------------------

    def _ensure_started(self) -> None:
        if self._threads is None:
            self._threads = [
                threading.Thread(target=self._produce, args=(j,),
                                 name=f"stream-decode-{j}", daemon=True)
                for j in range(self.n_sources)]
            for t in self._threads:
                t.start()

    def _produce(self, j: int) -> None:
        import time
        try:
            b, t = self.local_batch, self.tau
            st = self.stats[j]
            cursor, epochs = self._start[j]
            seeked = cursor != (0, 0)
            e = 0  # examples this reader produced (monotonic)
            slot = None
            while not self._stop.is_set():
                n_before = 0
                t0 = time.thread_time()  # CPU clock: see source_stats()
                for img, lbl, pos in self.loaders[j].iter_with_pos(cursor):
                    st["busy_cpu_s"] += time.thread_time() - t0
                    n_before += 1
                    r, within = divmod(e, self.block)
                    if within == 0:
                        tw = time.perf_counter()
                        slot = self._acquire(r, img.shape, img.dtype)
                        st["wait_s"] += time.perf_counter() - tw
                        if slot is None:
                            return  # stopped while waiting
                    t0 = time.thread_time()
                    c = j * self.block + within
                    wk, rem = divmod(c, t * b)
                    tt, jj = divmod(rem, b)
                    slot.data[tt, wk * b + jj] = img
                    slot.label[tt, wk * b + jj, 0] = lbl
                    e += 1
                    st["images"] += 1
                    if within == self.block - 1:
                        self._finish(slot, j, (pos, epochs))
                        slot = None
                    if self._stop.is_set():
                        return
                st["busy_cpu_s"] += time.thread_time() - t0
                if n_before == 0 and not seeked:
                    raise ValueError(
                        f"no decodable labeled images in reader {j}'s "
                        f"shards {self.loaders[j].shard_paths}")
                cursor = (0, 0)  # wrap this reader's shard subset
                seeked = False
                epochs += 1
        except BaseException as exc:  # surface in the consumer
            with self._cond:
                self._err = exc
                self._stop.set()
                self._cond.notify_all()

    def _acquire(self, r: int, shape, dtype) -> Optional[_RingSlot]:
        """Block until ring slot r%K is writable for round r; allocate its
        buffers on first touch. Returns None if the source is stopping."""
        slot = self._ring[r % self._K]
        with self._cond:
            while not self._stop.is_set() and slot.round != r:
                self._cond.wait(0.1)
            if self._stop.is_set():
                return None
            if slot.data is None:
                w, b, t = self.n_workers, self.local_batch, self.tau
                slot.data = np.empty((t, w * b) + tuple(shape), dtype)
                slot.label = np.empty((t, w * b, 1), np.int32)
        return slot

    def _finish(self, slot: _RingSlot, j: int, cursor) -> None:
        with self._cond:
            slot.cursors[j] = cursor
            slot.done += 1
            if slot.done == self.n_sources:
                slot.ready = True
                self._cond.notify_all()

    # -- consumer ------------------------------------------------------------

    def seek_rows(self, rows) -> bool:
        """Reposition all N readers from checkpoint rows
        [[shard, entry, epochs], ...]. Only before the first next_round().
        False when the row count doesn't match this reader count (shard
        assignment changed — caller restarts the stream from zero)."""
        if self._threads is not None:
            raise RuntimeError("seek_rows() after streaming started")
        if len(rows) != self.n_sources:
            return False
        self._start = [((int(r[0]), int(r[1])), int(r[2])) for r in rows]
        self.cursors = list(self._start)
        return True

    def next_round(self, round_index: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        self._ensure_started()
        with self._cond:
            slot = self._ring[self._next_out % self._K]
            while True:
                if self._err is not None:
                    raise RuntimeError(
                        "streaming decode thread failed") from self._err
                if slot.round == self._next_out and slot.ready:
                    break
                if self._stop.is_set():
                    raise RuntimeError("streaming source closed")
                self._cond.wait(0.1)
            batches = {"data": slot.data, "label": slot.label}
            self.cursors = list(slot.cursors)
            # recycle the slot for round (current + K)
            slot.round += self._K
            slot.ready = False
            slot.done = 0
            slot.data = slot.label = None
            slot.cursors = [None] * self.n_sources
            self._next_out += 1
            self._cond.notify_all()
        if round_index is not None:
            # same one-round-behind protocol as StreamingRoundSource:
            # checkpoints ask for cursor_at(trained round)
            self._round_cursors[round_index] = list(self.cursors)
            for k in [k for k in self._round_cursors
                      if k < round_index - 4]:
                del self._round_cursors[k]
        return batches

    def cursor_at(self, round_index: int) -> Optional[list]:
        """[((shard, entry), epochs), ...] per reader after the round that
        carried this index, if still retained."""
        return self._round_cursors.get(round_index)

    @property
    def skipped(self) -> int:
        return sum(ld.skipped for ld in self.loaders)

    def close(self) -> None:
        with self._cond:
            self._stop.set()
            self._cond.notify_all()
        if self._threads is not None:
            for t in self._threads:
                t.join(timeout=5.0)

    def __enter__(self) -> "ParallelStreamingSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_parallel_source(shard_paths, label_map, n_workers: int,
                         local_batch: int, tau: int, n_sources: int,
                         height: int = 256, width: int = 256,
                         prefetch_rounds: int = 2) -> ParallelStreamingSource:
    """Split a host's shards j::N across N readers (the same i::k mechanism
    `imagenet.host_shards` uses across hosts) and build the parallel
    source. N is clamped to the shard count — more readers than shards
    would leave empty readers."""
    loaders = _split_loaders(shard_paths, label_map, n_sources,
                             height, width)
    return ParallelStreamingSource(loaders, n_workers, local_batch, tau,
                                   prefetch_rounds=prefetch_rounds)
