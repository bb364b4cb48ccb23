"""The port's RecordIO (``io/recordio.py``), its native reader
(``io/_native.py`` over ``csrc/io/recordio_native.cc``) and its im2rec
(``tools/im2rec.py``) against the JAX package's on the same inputs:

  - ``.rec`` / ``.idx`` pairs written by either package are byte-equal and
    read in the other with equal records, sequentially and by key;
  - ``pack`` / ``unpack`` / ``pack_img`` / ``unpack_img`` give equal bytes
    and equal headers, float and array labels;
  - the native reader (one scan, reads by position and in batches on 1
    and 4 threads) equals the Python reader, and refuses a corrupt file;
    two processes building it at once into one build directory both load
    a whole library;
  - a pickled reader reopens at its position (a closed one at the start);
  - ``python -m incubator_mxnet_tpu_torch.tools.im2rec`` writes the same
    ``.lst`` / ``.rec`` / ``.idx`` bytes as the repository's
    ``tools/im2rec.py`` for one folder of JPEGs and ``.npy`` arrays.
"""

import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from incubator_mxnet_tpu.io import recordio as jrec

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.io import _native
from incubator_mxnet_tpu_torch.io import recordio as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _payloads(n=23, seed=0):
    rng = np.random.RandomState(seed)
    out = [b"", b"x", b"ab", b"abc"]       # lengths around the 4-byte pad
    for i in range(n - len(out)):
        out.append(rng.bytes(int(rng.randint(1, 300))))
    return out


def _write(rec_mod, prefix, payloads):
    w = rec_mod.IndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()


def _read_all(rec_mod, prefix):
    r = rec_mod.MXRecordIO(prefix + ".rec", "r")
    out = []
    while (p := r.read()) is not None:
        out.append(p)
    r.close()
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("writer,reader", [(trec, jrec), (jrec, trec)],
                         ids=["port_writes", "jax_writes"])
def test_records_and_idx_cross_the_packages(tmp_path, writer, reader):
    payloads = _payloads()
    _write(writer, str(tmp_path / "a"), payloads)
    _write(reader, str(tmp_path / "b"), payloads)
    for ext in (".rec", ".idx"):
        assert _bytes(tmp_path / f"a{ext}") == _bytes(tmp_path / f"b{ext}")
    assert _read_all(reader, str(tmp_path / "a")) == payloads
    r = reader.IndexedRecordIO(str(tmp_path / "a.idx"),
                               str(tmp_path / "a.rec"), "r")
    assert r.keys == list(range(len(payloads)))
    for i in (17, 0, 3, len(payloads) - 1):
        assert r.read_idx(i) == payloads[i]
    r.close()


def test_pack_unpack_cross_the_packages():
    cases = [(trec.IRHeader(0, 3.5, 7, 2), b"payload"),
             (trec.IRHeader(0, [1.0, 2.0, 3.0], 9, 0), b"\x00\x01"),
             (trec.IRHeader(0, np.arange(5, dtype=np.float32), 1, 1), b"")]
    for h, p in cases:
        s = trec.pack(h, p)
        assert s == jrec.pack(jrec.IRHeader(*h), p)
        th, tp = trec.unpack(s)
        jh, jp = jrec.unpack(s)
        assert tp == jp == p
        assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
        np.testing.assert_array_equal(np.asarray(th.label),
                                      np.asarray(jh.label))


def test_pack_img_unpack_img_equal_the_jax_package():
    img = (np.random.RandomState(1).rand(20, 30, 3) * 255).astype(np.uint8)
    h = trec.IRHeader(0, 2.0, 5, 0)
    s = trec.pack_img(h, img, quality=90)
    assert s == jrec.pack_img(jrec.IRHeader(*h), img, quality=90)
    th, timg = trec.unpack_img(s)
    jh, jimg = jrec.unpack_img(s)
    assert th.label == jh.label == 2.0
    np.testing.assert_array_equal(timg, jimg)
    assert timg.shape == (20, 30, 3) and timg.dtype == np.uint8


def test_native_reader_equals_python_reader(tmp_path):
    payloads = _payloads(40, seed=3)
    prefix = str(tmp_path / "n")
    _write(trec, prefix, payloads)
    for threads in (1, 4):
        nat = _native.NativeRecordReader(prefix + ".rec", n_threads=threads)
        assert len(nat) == len(payloads)
        assert [nat.read(i) for i in range(len(nat))] == payloads
        order = np.random.RandomState(threads).permutation(len(payloads))
        assert nat.read_batch(order) == [payloads[i] for i in order]
        assert nat.read_batch([]) == []
        # a reader pickles to one that reopens the file
        again = pickle.loads(pickle.dumps(nat))
        assert again.read_batch([5, 2]) == [payloads[5], payloads[2]]
        nat.close()
        again.close()
    raw = bytearray(_bytes(prefix + ".rec"))
    raw[8 + 4 + 8] ^= 0xFF                # the third record's magic
    (tmp_path / "bad.rec").write_bytes(bytes(raw))
    with pytest.raises(OSError, match="corrupt"):
        _native.NativeRecordReader(str(tmp_path / "bad.rec"))
    with pytest.raises(OSError, match="cannot open"):
        _native.NativeRecordReader(str(tmp_path / "missing.rec"))


_RACE = """
import sys
from pathlib import Path
from incubator_mxnet_tpu_torch.io import _native
_native._ROOT = Path(sys.argv[1])
assert _native.lib() is not None, _native.build_error("mxtpu_io")
print(len(_native.NativeRecordReader(sys.argv[2])))
"""


def test_two_processes_build_the_native_reader_at_once(tmp_path):
    """The test workers may build at once: each compiles to a file of its
    own and renames it into place, so both load a whole library."""
    prefix = str(tmp_path / "r")
    _write(trec, prefix, _payloads(9))
    env = dict(os.environ, PYTHONPATH=REPO)
    root = tmp_path / "checkout"
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(root),
                               prefix + ".rec"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "9"
    built = list((root / "build" / "native").iterdir())
    assert len(built) == 1
    assert sorted(f.name for f in built[0].iterdir()) == ["libmxtpu_io.so"]


def test_build_error_says_why(monkeypatch):
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(_native, "_ERRORS", {})
    monkeypatch.setenv("MXTPU_NO_NATIVE", "1")
    assert _native.lib() is None
    assert "MXTPU_NO_NATIVE" in _native.build_error("mxtpu_io")
    with pytest.raises(RuntimeError, match="unavailable"):
        _native.NativeRecordReader("any.rec")


def test_reader_pickles_at_its_position(tmp_path):
    path = str(tmp_path / "p.rec")
    w = trec.MXRecordIO(path, "w")
    for p in (b"hello", b"world", b"!"):
        w.write(p)
    w.close()
    r = trec.MXRecordIO(path, "r")
    assert r.read() == b"hello"
    assert pickle.loads(pickle.dumps(r)).read() == b"world"
    r.close()
    assert pickle.loads(pickle.dumps(r)).read() == b"hello"
    with pytest.raises(MXNetError, match="invalid flag"):
        trec.MXRecordIO(path, "a")
    with pytest.raises(MXNetError, match="not opened for writing"):
        trec.MXRecordIO(path, "r").write(b"x")


def test_top_level_aliases():
    assert mx.recordio is trec
    assert mx.io.recordio is trec
    assert mx.io.MXIndexedRecordIO is trec.IndexedRecordIO
    assert mx.io.pack is trec.pack and mx.io.unpack_img is trec.unpack_img


def _image_folder(root):
    rng = np.random.RandomState(0)
    import cv2
    for cls in ("cat", "dog"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            img = (rng.rand(12 + i, 16, 3) * 255).astype(np.uint8)
            if i == 2:
                np.save(root / cls / f"{i}.npy", img)
            else:
                ok, buf = cv2.imencode(".jpg", img)
                (root / cls / f"{i}.jpg").write_bytes(buf.tobytes())
    (root / "notes.txt").write_text("not an image class")


def test_im2rec_writes_the_reference_tools_bytes(tmp_path):
    root = tmp_path / "imgs"
    _image_folder(root)
    spec = importlib.util.spec_from_file_location(
        "_reference_im2rec", os.path.join(REPO, "tools", "im2rec.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want = str(tmp_path / "ref")
    assert ref.make_list(want, str(root), recursive=True) == 6
    assert ref.make_rec(want, str(root), quality=90) == 6
    got = str(tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in (["--list"], ["--quality", "90"]):
        run = subprocess.run(
            [sys.executable, "-m", "incubator_mxnet_tpu_torch.tools.im2rec",
             got, str(root), "--recursive", *extra],
            capture_output=True, text=True, env=env, timeout=300)
        assert run.returncode == 0, run.stderr
    assert "packed 6 records" in run.stdout
    for ext in (".lst", ".rec", ".idx"):
        assert _bytes(got + ext) == _bytes(want + ext)
    # not recursive: the top folder's images only (none here), label 0
    from incubator_mxnet_tpu_torch.tools import im2rec
    assert im2rec.make_list(str(tmp_path / "flat"), str(root / "cat")) == 3
    assert ref.make_list(str(tmp_path / "flat_ref"), str(root / "cat")) == 3
    assert _bytes(str(tmp_path / "flat.lst")) == \
        _bytes(str(tmp_path / "flat_ref.lst"))
