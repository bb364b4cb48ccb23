"""The port's image input path against the JAX package's on the same
records, on the CPU:

  - ``ImageRecordIter`` bitwise the JAX iterator's batches with the random
    augmentations off: centre crops and edge padding, ImageNet's mean and
    std, ``round_batch`` padding and its absence, ``num_parts`` /
    ``part_index``, ``label_width``; ``tell`` / ``set_position`` across a
    reset, shuffled, and through a checkpoint capsule; the normalization
    (``io.normalize_batch``, what the card runs) bitwise numpy's
    ``(x - mean) / std``; a batch bitwise the same at 1 and 4
    ``preprocess_threads`` with random crops and flips on, each image a
    window of its decoded record, flipped or not;
  - the codec chain: cv2 bitwise the JAX package's, PIL's link, the
    native libjpeg link (``io/_native_image.py``) within 2 of cv2, as
    ``tests/test_io_data.py`` holds the JAX package's batch decoder, and
    the batch decoder the same; no decoder raises;
  - the augmenters and image functions bitwise the JAX package's where
    they are deterministic, by property where they draw;
  - ``ImageDetIter`` / ``ImageDetRecordIter`` against the JAX package's
    with the augmentations off, the flip and crop by property, and a
    detection batch through one ``ssd_300`` ``SPMDTrainer`` step;
  - ``gluon.data.RecordFileDataset``, ``vision.ImageRecordDataset`` and
    ``vision.ImageFolderDataset``, and ``io.MNISTIter``, against the JAX
    package's.
"""

import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import image as jimage
from incubator_mxnet_tpu.gluon.data import RecordFileDataset as JRecordFile
from incubator_mxnet_tpu.gluon.data.vision import datasets as jdatasets
from incubator_mxnet_tpu.io import recordio as jrec

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import image as timage
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.io import _native_image, normalize_batch
from incubator_mxnet_tpu_torch.io import recordio as trec

cv2 = pytest.importorskip("cv2")

MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
            std_g=57.12, std_b=57.375)
SIZES = [(40, 50), (24, 30), (32, 32), (36, 28), (50, 40), (20, 20),
         (33, 47), (45, 45), (28, 36), (38, 41)]


def _img(rng, h, w):
    base = rng.rand(h // 4 + 1, w // 4 + 1, 3)
    img = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w] * 200
    return (img + rng.randint(0, 40, (h, w, 3))).astype(np.uint8)


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    """Two packs of JPEG records: ``plain`` (float labels, ten sizes
    around 32 x 32) and ``wide`` (3-wide label arrays)."""
    d = tmp_path_factory.mktemp("recs")
    rng = np.random.RandomState(0)
    imgs = [_img(rng, h, w) for h, w in SIZES]
    out = {"imgs": imgs}
    for name, label in (("plain", lambda i: float(i % 3)),
                        ("wide", lambda i: [float(i), i * 0.5, -1.0])):
        prefix = str(d / name)
        w = trec.IndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
        for i, img in enumerate(imgs):
            w.write_idx(i, trec.pack_img(trec.IRHeader(0, label(i), i, 0),
                                         img, quality=90))
        w.close()
        out[name] = prefix + ".rec"
    return out


def _batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _equal_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, round_batch=False, **MEAN),
    dict(batch_size=3, num_parts=3, part_index=1, **MEAN),
    dict(batch_size=4, data_shape=(3, 24, 40), preprocess_threads=3),
    dict(batch_size=5, label_width=2, rec="wide", **MEAN),
], ids=["pad", "no_round_mean_std", "parts", "wide_shape", "label_width"])
def test_image_record_iter_equals_the_jax_iterator(recs, kw):
    kw = dict(kw)
    path = recs[kw.pop("rec", "plain")]
    kw.setdefault("data_shape", (3, 32, 32))
    want = _batches(jmx.io.ImageRecordIter(path_imgrec=path, **kw))
    with mx.cpu():
        it = mx.io.ImageRecordIter(path_imgrec=path, **kw)
        assert it.reader == "native"
        got = _batches(it)
        assert it.provide_data[0].shape == (kw["batch_size"],) + \
            tuple(kw["data_shape"])
        it.reset()
        again = _batches(it)
    _equal_batches(got, want)
    _equal_batches(again, want)


def test_position_survives_a_reset_and_a_checkpoint(recs, tmp_path):
    from incubator_mxnet_tpu_torch import checkpoint as ckpt, gluon
    with mx.cpu():
        for shuffle in (False, True):
            mx.random.seed(11)
            a = mx.io.ImageRecordIter(recs["plain"], (3, 32, 32), 3,
                                      shuffle=shuffle, **MEAN)
            a.next()
            state = a.tell()
            assert set(state) == {"cursor", "num_records", "shuffle_seed"}
            rest = _batches(a)
            a.reset()
            a.set_position(state)
            _equal_batches(_batches(a), rest)
            b = mx.io.ImageRecordIter(recs["plain"], (3, 32, 32), 3,
                                      shuffle=shuffle, **MEAN)
            b.set_position(state)
            _equal_batches(_batches(b), rest)
        with pytest.raises(MXNetError, match="records"):
            b.set_position(dict(state, num_records=99))
        # through the capsule: a trainer's checkpoint carries the position
        net = gluon.nn.Dense(2, in_units=3)
        net.initialize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        m = ckpt.CheckpointManager(str(tmp_path), keep=0)
        pf = mx.io.PrefetchingIter(mx.io.ImageRecordIter(
            recs["plain"], (3, 32, 32), 2, shuffle=True))
        pf.next()
        tr.save_checkpoint(m, step=1, iterator=pf, block=True)
        want = _batches(pf)
        c = mx.io.PrefetchingIter(mx.io.ImageRecordIter(
            recs["plain"], (3, 32, 32), 2, shuffle=True))
        tr.restore_checkpoint(m, iterator=c)
        _equal_batches(_batches(c), want)
        m.close()


def test_normalization_is_numpys_formula():
    rng = np.random.RandomState(2)
    u8 = rng.randint(0, 256, (3, 7, 9, 3)).astype(np.uint8)
    mean = np.array([123.68, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    want = ((u8.astype(np.float32) - mean) / std).transpose(0, 3, 1, 2)
    got = normalize_batch(torch.from_numpy(u8), torch.from_numpy(mean),
                          torch.from_numpy(std))
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    bf = normalize_batch(torch.from_numpy(u8), torch.from_numpy(mean),
                         torch.from_numpy(std), torch.bfloat16)
    assert torch.equal(bf, torch.from_numpy(want).to(torch.bfloat16))
    gray = normalize_batch(torch.from_numpy(u8[..., :1]),
                           torch.from_numpy(mean), torch.from_numpy(std))
    np.testing.assert_array_equal(
        gray.numpy(), u8[..., :1].astype(np.float32).transpose(0, 3, 1, 2))


def _windows(img, H, W):
    """Every (H, W) window of ``img`` edge-padded as the iterator pads,
    and its flip."""
    h, w = img.shape[:2]
    out = []
    for y0 in range(max(h - H, 0) + 1):
        for x0 in range(max(w - W, 0) + 1):
            win = img[y0:y0 + H, x0:x0 + W]
            win = np.pad(win, ((0, H - win.shape[0]), (0, W - win.shape[1]),
                               (0, 0)), mode="edge")
            out += [win, win[:, ::-1]]
    return out


def test_random_crops_and_flips_are_thread_count_free(recs):
    with mx.cpu():
        runs = []
        for threads in (1, 4):
            mx.random.seed(7)
            it = mx.io.ImageRecordIter(recs["plain"], (3, 32, 32), 5,
                                       rand_crop=True, rand_mirror=True,
                                       preprocess_threads=threads)
            runs.append(_batches(it))
    _equal_batches(runs[1], runs[0])
    decoded = [trec.unpack_img(trec.pack_img(trec.IRHeader(0, 0, 0, 0),
                                             img, quality=90))[1]
               for img in recs["imgs"]]
    flips = 0
    for b, (data, _, _) in enumerate(runs[0]):
        for j in range(data.shape[0]):
            got = data[j].transpose(1, 2, 0).astype(np.uint8)
            img = decoded[b * 5 + j]
            cands = _windows(img, 32, 32)
            hit = [i for i, c in enumerate(cands) if np.array_equal(c, got)]
            assert hit, f"record {b * 5 + j} is no window of its image"
            flips += hit[0] % 2
    assert 0 < flips < 10


def test_batches_land_on_the_context_current_at_construction(recs):
    with mx.cpu():
        it = mx.io.ImageRecordIter(recs["plain"], (3, 32, 32), 4,
                                   dtype="bfloat16")
    b = it.next()                        # outside the with block
    assert b.data[0].context.device_type == "cpu"
    assert b.data[0].dtype == "bfloat16"
    with pytest.raises(MXNetError, match="dtype"):
        mx.io.ImageRecordIter(recs["plain"], (3, 32, 32), 4, dtype="int8")


def test_python_reader_when_the_native_one_is_missing(recs, monkeypatch):
    from incubator_mxnet_tpu_torch.io import _native
    with mx.cpu():
        want = _batches(mx.io.ImageRecordIter(recs["plain"], (3, 32, 32), 4))
        monkeypatch.setattr(_native, "lib", lambda: None)
        it = mx.io.ImageRecordIter(recs["plain"], (3, 32, 32), 4)
        assert it.reader == "python"
        _equal_batches(_batches(it), want)


# --------------------------------------------------------------------- #
# the codec chain
# --------------------------------------------------------------------- #

def _jpeg(img, quality=90):
    ok, buf = cv2.imencode(".jpg", img[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def test_codec_chain_links(monkeypatch):
    rng = np.random.RandomState(3)
    img = _img(rng, 33, 49)
    buf = _jpeg(img)
    ref = jimage.decode_to_numpy(buf)
    np.testing.assert_array_equal(timage.decode_to_numpy(buf), ref)
    np.testing.assert_array_equal(timage.decode_to_numpy(buf, flag=0),
                                  jimage.decode_to_numpy(buf, flag=0))
    assert timage.decoder().startswith("cv2")
    import io as _io
    bio = _io.BytesIO()
    np.save(bio, img)
    np.testing.assert_array_equal(
        timage.decode_to_numpy(b"NPY0" + bio.getvalue()), img)
    monkeypatch.setattr(timage, "_cv2", lambda: None)
    pil = timage.decode_to_numpy(buf)
    assert timage.decoder().startswith("PIL")
    assert pil.shape == ref.shape
    assert np.abs(pil.astype(int) - ref.astype(int)).max() <= 2
    monkeypatch.setattr(timage, "_pil_image", lambda: None)
    assert timage.decoder() == "libjpeg (native)"
    nat = timage.decode_to_numpy(buf)
    assert nat.shape == ref.shape and nat.dtype == np.uint8
    assert np.abs(nat.astype(int) - ref.astype(int)).max() <= 2
    gray = timage.decode_to_numpy(buf, flag=0)
    ref_gray = jimage.decode_to_numpy(buf, flag=0)
    assert gray.shape == ref_gray.shape == (33, 49, 1)
    assert np.abs(gray.astype(int) - ref_gray.astype(int)).max() <= 2
    bgr = timage.decode_to_numpy(buf, to_rgb=False)
    np.testing.assert_array_equal(bgr, nat[:, :, ::-1])
    assert _native_image.image_dims(buf) == (49, 33)
    with pytest.raises(MXNetError, match="decode failed"):
        timage.decode_to_numpy(b"\xff\xd8\xffnot a jpeg")
    monkeypatch.setattr(_native_image, "lib", lambda: None)
    assert timage.decoder() == "none"
    with pytest.raises(MXNetError, match="no image decoder"):
        timage.decode_to_numpy(buf)


def test_native_batch_decode_matches_cv2():
    rng = np.random.RandomState(0)
    payloads, refs = [], []
    for h, w in [(40, 56), (72, 72), (33, 49)]:
        img = _img(rng, h, w)
        payloads.append(_jpeg(img))
        dec = cv2.cvtColor(cv2.imdecode(np.frombuffer(payloads[-1], np.uint8),
                                        cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        refs.append(cv2.resize(dec, (24, 24), interpolation=cv2.INTER_LINEAR))
    out = timage.imdecode_resize_batch(payloads, 24, 24, n_threads=2)
    assert out.shape == (3, 24, 24, 3) and out.dtype == np.uint8
    for got, ref in zip(out, refs):
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2
    # a batch the native decoder refuses takes the chain image by image
    import io as _io
    bio = _io.BytesIO()
    np.save(bio, refs[0])
    mixed = timage.imdecode_resize_batch([b"NPY0" + bio.getvalue()] +
                                         payloads[1:], 24, 24)
    np.testing.assert_array_equal(mixed[0], refs[0])
    with pytest.raises(ValueError, match="item 1"):
        _native_image.decode_batch([payloads[0], b"junk"], 8, 8)


# --------------------------------------------------------------------- #
# image functions and augmenters
# --------------------------------------------------------------------- #

def _both(fn_name, *args, **kw):
    t = getattr(timage, fn_name)(*args, **kw)
    j = getattr(jimage, fn_name)(*args, **kw)
    return t, j


def _np_of(x):
    if isinstance(x, tuple):
        return tuple(_np_of(v) for v in x)
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_image_functions_equal_the_jax_package():
    rng = np.random.RandomState(4)
    img = _img(rng, 30, 44)
    cases = [("imresize", (img, 20, 16), {}), ("resize_short", (img, 24), {}),
             ("fixed_crop", (img, 3, 4, 20, 10), {}),
             ("fixed_crop", (img, 3, 4, 20, 10), {"size": (8, 6)}),
             ("center_crop", (img, (20, 16)), {}),
             ("copyMakeBorder", (img, 1, 2, 3, 4), {"values": 7.0}),
             ("imrotate", (img, 30.0), {}),
             ("imrotate", (img, -15.0), {"zoom_in": True}),
             ("imrotate", (img, 45.0), {"zoom_out": True}),
             ("color_normalize", (img, [1.0, 2.0, 3.0], [2.0, 4.0, 8.0]), {})]
    with mx.cpu():
        for name, args, kw in cases:
            t, j = _both(name, *args, **kw)
            if not isinstance(t, tuple):        # crops return a window too
                t, j = (t,), (j,)
            for a, b in zip(_np_of(t), _np_of(j)):
                np.testing.assert_allclose(np.asarray(a, np.float64),
                                           np.asarray(b, np.float64),
                                           rtol=1e-6, atol=1e-4,
                                           err_msg=name)
        with pytest.raises(MXNetError, match="BORDER_CONSTANT"):
            timage.copyMakeBorder(img, 1, 1, 1, 1, type=1)
        with pytest.raises(MXNetError, match="exclusive"):
            timage.imrotate(img, 1.0, zoom_in=True, zoom_out=True)


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=36, mean=True, std=True),
    dict(rand_crop=True, rand_mirror=True, brightness=0.1, contrast=0.1,
         saturation=0.1, hue=0.1, pca_noise=0.1, rand_gray=0.2)])
def test_create_augmenter_builds_the_jax_list(kw):
    t = timage.CreateAugmenter((3, 24, 24), **kw)
    j = jimage.CreateAugmenter((3, 24, 24), **kw)
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    assert [a.dumps() for a in t] == [a.dumps() for a in j]


def test_deterministic_augmenters_equal_the_jax_package():
    rng = np.random.RandomState(5)
    img = _img(rng, 30, 40)
    pairs = [(timage.ResizeAug(20), jimage.ResizeAug(20)),
             (timage.ForceResizeAug((16, 12)), jimage.ForceResizeAug((16, 12))),
             (timage.CenterCropAug(20), jimage.CenterCropAug(20)),
             (timage.CastAug(), jimage.CastAug()),
             (timage.ColorNormalizeAug([10., 20., 30.], [2., 3., 4.]),
              jimage.ColorNormalizeAug([10., 20., 30.], [2., 3., 4.])),
             (timage.HueJitterAug(0.0), jimage.HueJitterAug(0.0))]
    with mx.cpu():
        for t, j in pairs:
            got, want = t(img).asnumpy(), j(img).asnumpy()
            assert got.dtype == want.dtype, type(t).__name__
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4,
                                       err_msg=type(t).__name__)
            assert t(img).context.device_type == "cpu"


def test_random_augmenters_by_property():
    rng = np.random.RandomState(6)
    img = _img(rng, 30, 40).astype(np.float32)
    with mx.cpu():
        mx.random.seed(1)
        crop = timage.RandomCropAug(16)(img).asnumpy()
        assert any(np.array_equal(crop, img[y:y + 16, x:x + 16])
                   for y in range(15) for x in range(25))
        np.testing.assert_array_equal(
            timage.HorizontalFlipAug(1.0)(img).asnumpy(), img[:, ::-1])
        np.testing.assert_array_equal(
            timage.HorizontalFlipAug(0.0)(img).asnumpy(), img)
        b = timage.BrightnessJitterAug(0.3)(img).asnumpy()
        ratio = b[img > 0] / img[img > 0]
        assert np.ptp(ratio) < 1e-5 and 0.7 <= ratio[0] <= 1.3
        g = timage.RandomGrayAug(1.0)(img).asnumpy()
        assert np.array_equal(g[..., 0], g[..., 1]) and \
            np.array_equal(g[..., 1], g[..., 2])
        for aug in (timage.ContrastJitterAug(0.0),
                    timage.SaturationJitterAug(0.0),
                    timage.ColorJitterAug(0.0, 0.0, 0.0)):
            np.testing.assert_allclose(aug(img).asnumpy(), img, rtol=1e-6,
                                       atol=1e-4)
        light = timage.LightingAug(0.1, [55.46, 4.794, 1.148],
                                   np.eye(3))(img).asnumpy()
        shift = (light - img).reshape(-1, 3)
        assert np.ptp(shift, axis=0).max() < 1e-3
        out, (x0, y0, w, h) = timage.random_size_crop(img, (12, 10),
                                                      (0.3, 1.0), (0.75, 1.33))
        assert out.shape == (10, 12, 3) and 0 <= x0 <= 40 - w and \
            0 <= y0 <= 30 - h
        rot = timage.random_rotate(img, (-10, 10)).asnumpy()
        assert rot.shape == img.shape and np.isfinite(rot).all()


def test_imdecode_and_imread_on_the_current_context(tmp_path):
    img = _img(np.random.RandomState(7), 20, 24)
    buf = _jpeg(img)
    np.save(tmp_path / "a.npy", img)
    (tmp_path / "a.jpg").write_bytes(buf)
    with mx.cpu():
        a = timage.imdecode(buf)
        assert a.context.device_type == "cpu" and a.dtype == np.uint8
        np.testing.assert_array_equal(a.asnumpy(),
                                      jimage.imdecode(buf).asnumpy())
        np.testing.assert_array_equal(
            timage.imread(str(tmp_path / "a.jpg")).asnumpy(), a.asnumpy())
        np.testing.assert_array_equal(
            timage.imread(str(tmp_path / "a.npy")).asnumpy(), img)
    with pytest.raises(MXNetError, match="path_imgrec"):
        timage.ImageIter(2, (3, 16, 16))


def test_image_iter_wraps_the_record_iter(recs):
    with mx.cpu():
        got = _batches(timage.ImageIter(4, (3, 32, 32),
                                        path_imgrec=recs["plain"]))
    want = _batches(jimage.ImageIter(4, (3, 32, 32),
                                     path_imgrec=recs["plain"]))
    _equal_batches(got, want)


# --------------------------------------------------------------------- #
# detection
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    """Six records of 40 x 48 images with one or two boxes each in
    MXNet's detection header (``[2, 5, objects...]``)."""
    d = tmp_path_factory.mktemp("det")
    rng = np.random.RandomState(8)
    path = str(d / "det.rec")
    w = trec.MXRecordIO(path, "w")
    for i in range(6):
        objs = []
        for o in range(1 + i % 2):
            x1, y1 = rng.uniform(0.0, 0.5, 2)
            objs += [float(o + i % 3), x1, y1, x1 + 0.3, y1 + 0.4]
        w.write(trec.pack_img(trec.IRHeader(0, [2.0, 5.0] + objs, i, 0),
                              _img(rng, 40, 48), quality=90))
    w.close()
    return path


def test_det_record_iter_equals_the_jax_iterator(det_rec):
    kw = dict(path_imgrec=det_rec, data_shape=(3, 32, 32), batch_size=4,
              **MEAN)
    want = _batches(jmx.io.ImageDetRecordIter(**kw))
    with mx.cpu():
        it = mx.io.ImageDetRecordIter(preprocess_threads=3, **kw)
        got = _batches(it)
    _equal_batches(got, want)
    assert got[0][1].shape == (4, 2, 5)
    assert (got[0][1][0, 1] == -1).all()        # a padded object row
    assert it.provide_label[0].shape == (4, 2, 5)


def test_det_augmenters_by_property(det_rec):
    from incubator_mxnet_tpu_torch.image import detection as tdet
    rng = np.random.RandomState(9)
    img = _img(rng, 40, 48)
    lab = np.array([[1, 0.1, 0.2, 0.5, 0.6], [0, 0.4, 0.4, 0.9, 0.8],
                    [-1, -1, -1, -1, -1]], np.float32)
    with mx.cpu():
        out, flipped = tdet.DetHorizontalFlipAug(1.0)(img, lab)
        np.testing.assert_array_equal(out.asnumpy(), img[:, ::-1])
        np.testing.assert_allclose(flipped[:2, 1], 1 - lab[:2, 3])
        np.testing.assert_allclose(flipped[:2, 3], 1 - lab[:2, 1])
        np.testing.assert_array_equal(flipped[2], lab[2])
        mx.random.seed(3)
        for _ in range(5):
            cimg, clab = tdet.DetRandomCropAug(0.3, (0.3, 1.0))(img, lab)
            valid = clab[clab[:, 0] >= 0]
            assert len(valid) >= 1
            assert (valid[:, 1:] >= 0).all() and (valid[:, 1:] <= 1).all()
            assert (valid[:, 1] <= valid[:, 3]).all()
            assert _np_of(cimg).shape[0] <= 40
        augs = tdet.CreateDetAugmenter((3, 32, 32), resize=36, rand_crop=0.5,
                                       rand_mirror=True, mean=True, std=True)
        from incubator_mxnet_tpu.image import detection as jdet
        jaugs = jdet.CreateDetAugmenter((3, 32, 32), resize=36, rand_crop=0.5,
                                        rand_mirror=True, mean=True,
                                        std=True)
        assert [type(a).__name__ for a in augs] == \
            [type(a).__name__ for a in jaugs]
        it = tdet.ImageDetIter(2, (3, 32, 32), path_imgrec=det_rec,
                               aug_list=augs, shuffle=True)
        b = it.next()
        assert b.data[0].shape == (2, 3, 32, 32)
        assert b.label[0].shape == (2, 2, 5)
    with pytest.raises(MXNetError, match="imgs"):
        tdet.ImageDetIter(2, (3, 32, 32))


def test_det_batch_feeds_ssd_training(det_rec):
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.models.ssd import ssd_300

    def forward_loss(model, x, y):
        anchors, cls_preds, box_preds = model(x)
        bt, bm, ct = model.training_targets(anchors, cls_preds, y)
        return model.loss(cls_preds, box_preds, bt, bm, ct)

    with mx.cpu():
        it = mx.io.ImageDetRecordIter(path_imgrec=det_rec,
                                      data_shape=(3, 64, 64), batch_size=2,
                                      **MEAN)
        b = it.next()
        mx.random.seed(0)
        net = ssd_300(num_classes=3)
        net.initialize()
        net(b.data[0])
        tr = parallel.SPMDTrainer(net, forward_loss=forward_loss,
                                  optimizer="sgd",
                                  optimizer_params={"learning_rate": 0.01})
        loss = float(tr.step(b.data[0], b.label[0]).asnumpy())
    assert np.isfinite(loss) and tr.step_count == 1


# --------------------------------------------------------------------- #
# gluon datasets and MNISTIter
# --------------------------------------------------------------------- #

def test_record_datasets_equal_the_jax_package(recs):
    from incubator_mxnet_tpu_torch.gluon.data import (DataLoader,
                                                      RecordFileDataset)
    from incubator_mxnet_tpu_torch.gluon.data.vision import (
        ImageRecordDataset, transforms)
    t, j = RecordFileDataset(recs["plain"]), JRecordFile(recs["plain"])
    assert len(t) == len(j) == len(SIZES)
    assert [t[i] for i in range(len(t))] == [j[i] for i in range(len(j))]
    t = ImageRecordDataset(recs["plain"])
    j = jdatasets.ImageRecordDataset(recs["plain"])
    for i in (0, 4, 9):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert isinstance(ti, np.ndarray)
        np.testing.assert_array_equal(ti, np.asarray(ji.asnumpy()))
        assert tl == jl
    with mx.cpu():
        loader = DataLoader(
            ImageRecordDataset(recs["plain"]).transform_first(
                lambda x: transforms.ToTensor()(x[:20, :20])),
            batch_size=5)
        x, y = next(iter(loader))
    assert x.shape == (5, 3, 20, 20) and y.shape == (5,)


def test_image_folder_dataset_equals_the_jax_package(tmp_path):
    from incubator_mxnet_tpu_torch.gluon.data.vision import ImageFolderDataset
    rng = np.random.RandomState(10)
    for cls in ("b_dog", "a_cat"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            (tmp_path / cls / f"{i}.jpg").write_bytes(_jpeg(_img(rng, 12, 16)))
    (tmp_path / "a_cat" / "skip.txt").write_text("x")
    t = ImageFolderDataset(str(tmp_path))
    j = jdatasets.ImageFolderDataset(str(tmp_path))
    assert t.synsets == j.synsets == ["a_cat", "b_dog"]
    assert t.items == j.items and len(t) == 4
    for i in range(4):
        (ti, tl), (ji, jl) = t[i], j[i]
        np.testing.assert_array_equal(ti, ji.asnumpy())
        assert tl == jl
    gray = ImageFolderDataset(str(tmp_path), flag=0)[0][0]
    assert gray.shape == (12, 16, 1)


@pytest.mark.parametrize("kw", [dict(), dict(flat=True, num_parts=2,
                                             part_index=1)])
def test_mnist_iter_equals_the_jax_iterator(tmp_path, kw):
    image = str(tmp_path / "train-images-idx3-ubyte")
    args = dict(image=image, batch_size=100, shuffle=False, **kw)
    want = _batches(jmx.io.MNISTIter(**args))
    got = _batches(mx.io.MNISTIter(**args))
    _equal_batches(got, want)
    assert len(got) == (60 if not kw else 30)
