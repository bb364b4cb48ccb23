"""im2rec: pack an image folder or a ``.lst`` file into a ``.rec`` /
``.idx`` RecordIO pair (parity: MXNet's ``tools/im2rec.py``); the port's
copy of the JAX repository's ``tools/im2rec.py``, with the same
arguments and the same ``.lst`` / ``.rec`` / ``.idx`` bytes.

Usage:
    python -m incubator_mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list \
        [--recursive]                  # write PREFIX.lst
    python -m incubator_mxnet_tpu_torch.tools.im2rec PREFIX ROOT \
        [--recursive] [--quality Q]   # pack (writing PREFIX.lst first if
                                       # it is missing)

Image files are packed as their bytes; a ``.npy`` array is encoded as a
JPEG (``recordio.pack_img``). With ``--recursive`` each subfolder of ROOT
is a class, labelled in sorted order.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.recordio import IndexedRecordIO, IRHeader, pack, pack_img

__all__ = ["make_list", "read_list", "make_rec", "main"]

EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".npy")


def make_list(prefix, root, recursive=False, train_ratio=1.0, exts=None):
    """Write ``PREFIX.lst`` (``index<TAB>label<TAB>path`` lines) for the
    images under ``root``; returns their number."""
    exts = exts or EXTS
    items = []
    if recursive:
        labels = {}
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = labels.setdefault(folder, len(labels))
            for fname in sorted(os.listdir(path)):
                if os.path.splitext(fname)[1].lower() in exts:
                    items.append((os.path.join(folder, fname), label))
    else:
        for fname in sorted(os.listdir(root)):
            if os.path.splitext(fname)[1].lower() in exts:
                items.append((fname, 0))
    with open(prefix + ".lst", "w") as f:
        for i, (rel, label) in enumerate(items):
            f.write(f"{i}\t{label}\t{rel}\n")
    return len(items)


def read_list(path):
    """``(index, label, relative path)`` of each line of a ``.lst``."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            yield int(parts[0]), float(parts[1]), parts[-1]


def make_rec(prefix, root, quality=95):
    """Pack the images ``PREFIX.lst`` names into ``PREFIX.rec`` and
    ``PREFIX.idx``; returns the records written."""
    rec = IndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    n = 0
    try:
        for idx, label, rel in read_list(prefix + ".lst"):
            path = os.path.join(root, rel)
            header = IRHeader(0, label, idx, 0)
            if path.endswith(".npy"):
                rec.write_idx(idx, pack_img(header, np.load(path), quality,
                                            ".jpg"))
            else:
                with open(path, "rb") as f:
                    rec.write_idx(idx, pack(header, f.read()))
            n += 1
    finally:
        rec.close()
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("prefix")
    ap.add_argument("root")
    ap.add_argument("--list", action="store_true",
                    help="generate PREFIX.lst instead of packing")
    ap.add_argument("--recursive", action="store_true",
                    help="class-per-subfolder labels")
    ap.add_argument("--quality", type=int, default=95)
    args = ap.parse_args(argv)
    if args.list:
        n = make_list(args.prefix, args.root, args.recursive)
        print(f"wrote {n} entries to {args.prefix}.lst")
    else:
        if not os.path.exists(args.prefix + ".lst"):
            make_list(args.prefix, args.root, args.recursive)
        n = make_rec(args.prefix, args.root, args.quality)
        print(f"packed {n} records into {args.prefix}.rec")


if __name__ == "__main__":
    main()
