"""Re-shard ImageNet into shuffled tar chunks + label files.

The port's copy of the JAX package's `scripts/shard_imagenet.py`: for the
same input tars and seed it writes the same shard and label files, byte
for byte; its `--upload` pushes through the port's own `data/gcs.py` and
`data/s3.py` clients.

Parity with the reference's `scripts/put_imagenet_on_s3.py` (Python 2 +
boto): reads the ILSVRC2012 training tar-of-tars and/or the flat validation
tar, re-shards into N shuffled chunks of resized JPEGs, and writes
`train.NNNN.tar` / `val.NNNN.tar` plus `train.txt` / `val.txt`
"filename label" maps — into a local directory (sync to object storage with
`gsutil -m rsync` afterwards, or `--upload`; no cloud SDK dependency here).

Train labels come from the sorted synset order (reference convention);
validation labels come from a provided `--val-label-file` in the standard
"ILSVRC2012_val_XXXXXXXX.JPEG <label>" format (the reference fetched the
same file from caffe_ilsvrc12.tar.gz; reference `process_val_files`,
put_imagenet_on_s3.py:64-77).

Usage:
  python -m sparknet_tpu_torch.scripts.shard_imagenet --out data/imagenet \
      [--train-tar ILSVRC2012_img_train.tar --shards 1000] \
      [--val-tar ILSVRC2012_img_val.tar --val-label-file val_truth.txt \
       --val-shards 50] \
      [--size 256]
"""
from __future__ import annotations

import argparse
import io
import os
import random
import tarfile
from typing import Dict, List


def resize_jpeg(data: bytes, size: int) -> bytes:
    from PIL import Image
    img = Image.open(io.BytesIO(data)).convert("RGB").resize(
        (size, size), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    return buf.getvalue()


class ShardWriters:
    """Lazily-opened `<split>.NNNN.tar` writers."""

    def __init__(self, out_dir: str, split: str):
        self.out_dir = out_dir
        self.split = split
        self.writers: Dict[int, tarfile.TarFile] = {}

    def add(self, shard_id: int, name: str, data: bytes) -> None:
        w = self.writers.get(shard_id)
        if w is None:
            w = tarfile.open(os.path.join(
                self.out_dir, f"{self.split}.{shard_id:04d}.tar"), "w")
            self.writers[shard_id] = w
        info = tarfile.TarInfo(name=name)
        info.size = len(data)
        w.addfile(info, io.BytesIO(data))

    def close(self) -> int:
        for w in self.writers.values():
            w.close()
        return len(self.writers)


def write_labels(out_dir: str, split: str, lines: List[str]) -> None:
    with open(os.path.join(out_dir, f"{split}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def shard_train(train_tar: str, out: str, shards: int, size: int,
                seed: int) -> None:
    # pass 1: class list -> labels (sorted synset order, reference convention)
    with tarfile.open(train_tar) as outer:
        class_tars = sorted(m.name for m in outer if m.isfile())
    label_of = {name: i for i, name in enumerate(class_tars)}
    print(f"{len(class_tars)} classes")

    # pass 2: enumerate images, assign shuffled shard ids
    entries = []  # (class_tar_name, member_name)
    with tarfile.open(train_tar) as outer:
        for m in outer:
            if not m.isfile():
                continue
            inner = tarfile.open(fileobj=outer.extractfile(m))
            for im in inner:
                if im.isfile():
                    entries.append((m.name, im.name))
    rng = random.Random(seed)
    rng.shuffle(entries)
    shard_of = {e: i * shards // len(entries) for i, e in enumerate(entries)}
    print(f"{len(entries)} train images -> {shards} shards")

    writers = ShardWriters(out, "train")
    labels = []
    with tarfile.open(train_tar) as outer:
        for m in outer:
            if not m.isfile():
                continue
            inner = tarfile.open(fileobj=outer.extractfile(m))
            for im in inner:
                if not im.isfile():
                    continue
                base = os.path.basename(im.name)
                data = resize_jpeg(inner.extractfile(im).read(), size)
                writers.add(shard_of[(m.name, im.name)], base, data)
                labels.append(f"{base} {label_of[m.name]}")
    n = writers.close()
    write_labels(out, "train", labels)
    print(f"wrote {n} train shards + train.txt under {out}")


def shard_val(val_tar: str, val_label_file: str, out: str, shards: int,
              size: int, seed: int) -> None:
    """Reference `process_val_files` (put_imagenet_on_s3.py:64-77): split
    the shuffled label list into chunks, write one resized tar per chunk."""
    with open(val_label_file) as f:
        pairs = []
        for lineno, ln in enumerate(f, 1):
            if not ln.strip():
                continue
            toks = ln.split()
            if len(toks) != 2 or not toks[1].lstrip("-").isdigit():
                raise SystemExit(
                    f"{val_label_file}:{lineno}: expected 'filename label' "
                    f"(caffe_ilsvrc12 val.txt format), got {ln.strip()!r} — "
                    "the ILSVRC devkit ground-truth file (label-only lines) "
                    "must be joined with filenames first")
            pairs.append((toks[0], toks[1]))
    rng = random.Random(seed)
    rng.shuffle(pairs)
    shard_of = {name: i % shards for i, (name, _) in enumerate(pairs)}

    writers = ShardWriters(out, "val")
    labels = []
    found = set()
    with tarfile.open(val_tar) as tar:
        label_map = {name: lbl for name, lbl in pairs}
        for m in tar:
            if not m.isfile():
                continue
            base = os.path.basename(m.name)
            lbl = label_map.get(base)
            if lbl is None:
                print(f"warning: {base} not in {val_label_file}, skipped")
                continue
            data = resize_jpeg(tar.extractfile(m).read(), size)
            writers.add(shard_of[base], base, data)
            labels.append(f"{base} {lbl}")
            found.add(base)
    missing = [n for n, _ in pairs if n not in found]
    if missing:
        print(f"warning: {len(missing)} labeled files not in the val tar "
              f"(first: {missing[0]})")
    n = writers.close()
    write_labels(out, "val", labels)
    print(f"wrote {n} val shards + val.txt under {out}")


def upload_dir(out: str, dest: str) -> int:
    """Push every shard + label file under `out` to a gs:// or s3://
    prefix — the reference sharder's upload side (put_imagenet_on_s3.py
    pushed each chunk to S3 as it was built; here local shards are the
    staging area and the push reuses the framework's native bucket
    clients, so no cloud SDK is needed on the ingest box either)."""
    from ..data.gcs import gs_write, is_gs_path
    from ..data.s3 import is_s3_path, s3_write
    if not (is_gs_path(dest) or is_s3_path(dest)):
        raise SystemExit(f"--upload must be gs:// or s3://, got {dest!r}")
    write = gs_write if is_gs_path(dest) else s3_write
    dest = dest.rstrip("/")
    n = 0
    for f in sorted(os.listdir(out)):
        if not (f.endswith(".tar") or f.endswith(".txt")):
            continue
        path = os.path.join(out, f)
        size = os.path.getsize(path)
        if size > (1 << 30):
            # each upload is one in-memory PUT (a retry re-sends the whole
            # body); huge shards want more --shards, not multipart logic
            print(f"warning: {f} is {size >> 20} MiB — single-shot upload "
                  f"holds it in RAM and a retry re-sends it all; consider "
                  f"more --shards for smaller chunks")
        with open(path, "rb") as fh:
            write(f"{dest}/{f}", fh.read())
        n += 1
        print(f"uploaded {dest}/{f}")
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train-tar",
                   help="ILSVRC2012_img_train.tar (tar of per-class tars)")
    p.add_argument("--val-tar", help="ILSVRC2012_img_val.tar (flat JPEGs)")
    p.add_argument("--val-label-file",
                   help="'filename label' ground truth for the val tar")
    p.add_argument("--out", required=True)
    p.add_argument("--shards", type=int, default=1000)
    p.add_argument("--val-shards", type=int, default=50)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--upload", metavar="gs://B/P|s3://B/P", default=None,
                   help="after sharding, push shards + label files to this "
                   "bucket prefix (native clients; no SDK)")
    args = p.parse_args(argv)

    if not args.train_tar and not args.val_tar and not args.upload:
        p.error("nothing to do: pass --train-tar and/or --val-tar "
                "(and/or --upload to push an existing --out)")
    if args.val_tar and not args.val_label_file:
        p.error("--val-tar needs --val-label-file (ground-truth labels)")
    os.makedirs(args.out, exist_ok=True)
    if args.train_tar:
        shard_train(args.train_tar, args.out, args.shards, args.size,
                    args.seed)
    if args.val_tar:
        shard_val(args.val_tar, args.val_label_file, args.out,
                  args.val_shards, args.size, args.seed)
    if args.upload:
        n = upload_dir(args.out, args.upload)
        print(f"uploaded {n} files to {args.upload}")


if __name__ == "__main__":
    main()
