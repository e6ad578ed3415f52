"""The port's input pipeline (facesr_torch.data, facesr_torch.native)
against cv2 and the JAX package's `facesr/data/` on the same seeded files:
PNG decode, the cv2 copies (HSV, bicubic), transforms, loaders."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from facesr import native as jnative
from facesr.data import get_dataloader as jax_get_dataloader
from facesr.data.dataset import FFHQDataset as JaxDataset
from facesr.data.fast_loader import FastHRLoader as JaxFastHRLoader
from facesr.data.loader import host_shard as jax_host_shard
from facesr.data.transforms import PairedTransform as JaxPairedTransform
from facesr_torch import native
from facesr_torch.data import cv_compat, png
from facesr_torch.data.dataset import FFHQDataset, ImageCache, get_dataloader
from facesr_torch.data.fast_loader import FastHRLoader
from facesr_torch.data.loader import DataLoader, host_shard
from facesr_torch.data.transforms import PairedTransform

torch.set_num_threads(1)


def _face(rng, h, w, c=3):
    """A smooth image with noise, an edge and black rows, so libpng's
    adaptive filtering picks every filter type somewhere."""
    lo = (rng.random((6, 6, c)) * 255).astype(np.uint8)
    img = cv2.resize(lo, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c).astype(int)
    img[: h // 3] += rng.integers(-40, 40, (h // 3, w, c))
    img[:, w // 2:w // 2 + 3] = 255
    img[-2:] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def _filter_types_of(data):
    """The row filter types used in PNG bytes."""
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, ctype = hdr[:4]
    rowbytes = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    return {raw[y * (rowbytes + 1)] for y in range(h)}


def _cv2_write(path, img, level):
    """Write RGB(A)/grey ``img`` with cv2 (BGR order on disk)."""
    if img.shape[2] == 3:
        img = img[..., ::-1]
    elif img.shape[2] == 4:
        img = img[..., [2, 1, 0, 3]]
    assert cv2.imwrite(str(path), np.ascontiguousarray(img),
                       [cv2.IMWRITE_PNG_COMPRESSION, level])


@pytest.mark.parametrize("level", [0, 3, 9])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decode_equals_cv2_imread(tmp_path, channels, level):
    rng = np.random.default_rng(channels * 10 + level)
    path = tmp_path / "x.png"
    _cv2_write(path, _face(rng, 45, 61, channels), level)
    want = cv2.imread(str(path))[..., ::-1]
    assert np.array_equal(png.read_rgb(path), want)
    assert np.array_equal(png.read_rgb(path, unfilter=native.png_unfilter_numpy), want)


def test_cv2_files_carry_all_five_filters(tmp_path):
    seen = set()
    for channels in (1, 3, 4):
        for level in (0, 3, 9):
            path = tmp_path / f"{channels}{level}.png"
            _cv2_write(path, _face(np.random.default_rng(channels * 10 + level), 45, 61,
                                   channels), level)
            seen |= _filter_types_of(path.read_bytes())
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("filter_type", range(5))
def test_png_encode_round_trips_and_cv2_reads_it(tmp_path, filter_type):
    rng = np.random.default_rng(filter_type)
    for channels in (1, 2, 3, 4):
        img = _face(rng, 23, 37, channels)
        data = png.encode(img, level=6, filter_type=filter_type)
        assert _filter_types_of(data) == {filter_type}
        assert np.array_equal(png.decode(data), img)
        path = tmp_path / f"e{channels}.png"
        path.write_bytes(data)
        back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        back = back[..., None] if back.ndim == 2 else back
        if channels == 3:
            back = back[..., ::-1]
        elif channels == 4:
            back = back[..., [2, 1, 0, 3]]
        if channels != 2:  # cv2 reads grey + alpha as BGRA
            assert np.array_equal(back, img)
        # IMREAD_COLOR: grey replicated, alpha dropped
        assert np.array_equal(png.read_rgb(path), cv2.imread(str(path))[..., ::-1])


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_equals_numpy(bpp):
    rng = np.random.default_rng(bpp)
    h, rowbytes = 17, 29 * bpp
    rows = rng.integers(0, 256, (h, rowbytes + 1), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h)
    data = rows.tobytes()
    got = native.png_unfilter(data, h, rowbytes, bpp)
    assert np.array_equal(got, native.png_unfilter_numpy(data, h, rowbytes, bpp))
    rows[5, 0] = 7
    for fn in (native.png_unfilter, native.png_unfilter_numpy):
        with pytest.raises(ValueError, match="row 5 has filter type 7"):
            fn(rows.tobytes(), h, rowbytes, bpp)


def _with_ihdr(data, **changes):
    """``data`` with IHDR fields changed and its CRC fixed."""
    fields = list(struct.unpack(">IIBBBBB", data[16:29]))
    for i, k in enumerate(("width", "height", "depth", "ctype", "comp", "filt", "interlace")):
        fields[i] = changes.get(k, fields[i])
    body = struct.pack(">IIBBBBB", *fields)
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def test_unsupported_and_corrupt_files_raise_with_their_name(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    img = _face(rng, 16, 16)
    cases = {}
    cv2.imwrite(str(tmp_path / "deep.png"), (img.astype(np.uint16) * 257))
    cases["deep.png"] = "16-bit"
    Image.fromarray(img).convert("P").save(tmp_path / "pal.png")
    cases["pal.png"] = "palette"
    (tmp_path / "inter.png").write_bytes(_with_ihdr(png.encode(img), interlace=1))
    cases["inter.png"] = "interlaced"
    cv2.imwrite(str(tmp_path / "face.jpg"), img)
    cases["face.jpg"] = "not a PNG"
    cv2.imwrite(str(tmp_path / "face.bmp"), img)
    cases["face.bmp"] = "not a PNG"
    good = bytearray(png.encode(img))
    good[len(good) // 2] ^= 0xFF
    (tmp_path / "crc.png").write_bytes(bytes(good))
    cases["crc.png"] = "CRC mismatch"
    (tmp_path / "short.png").write_bytes(png.encode(img)[:60])
    cases["short.png"] = "truncated"
    for name, what in cases.items():
        with pytest.raises(png.PNGError, match=what) as e:
            png.read_rgb(tmp_path / name)
        assert name in str(e.value)


def _hsv_sample():
    """2^20 seeded RGB triples plus the 256 greys, laid out as 4112 rows of
    256 pixels (OpenCV's vector path) and as a row with a scalar tail."""
    rng = np.random.default_rng(0)
    greys = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    return np.concatenate([rng.integers(0, 256, (1 << 20, 3), dtype=np.uint8), greys])


@pytest.mark.parametrize("width", [256, 33])
def test_hsv_round_trip_matches_cv2(width):
    flat = _hsv_sample()
    n = len(flat) // width * width
    rgb = flat[:n].reshape(-1, width, 3)
    hsv = cv_compat.rgb_to_hsv(rgb)
    want_hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    back = cv_compat.hsv_to_rgb(want_hsv)
    want_back = cv2.cvtColor(want_hsv, cv2.COLOR_HSV2RGB)
    # the jitter's saturation scale moves S, so HSV2RGB also sees other S
    scaled = want_hsv.copy()
    scaled[..., 1] = np.clip(scaled[..., 1] * 1.07, 0, 255).astype(np.uint8)
    back2 = cv_compat.hsv_to_rgb(scaled)
    want_back2 = cv2.cvtColor(scaled, cv2.COLOR_HSV2RGB)
    for name, got, want in (("RGB2HSV", hsv, want_hsv), ("HSV2RGB", back, want_back),
                            ("HSV2RGB, S x 1.07", back2, want_back2)):
        diff = np.abs(got.astype(int) - want.astype(int))
        off = int((diff > 0).sum())
        print(f"{name} width {width}: {off} of {diff.size} values off, max {diff.max()}")
        assert diff.max() <= 1 and off <= 1e-3 * diff.size


@pytest.mark.parametrize("shape", [(256, 256), (300, 300), (128, 96)])
def test_bicubic_quarter_downscale_matches_cv2(shape):
    rng = np.random.default_rng(shape[0])
    for smooth in (False, True):
        img = _face(rng, *shape) if smooth else rng.integers(0, 256, shape + (3,), np.uint8)
        size = (shape[1] // 4, shape[0] // 4)
        got = cv_compat.resize_cubic(img, size)
        want = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
        diff = np.abs(got.astype(int) - want.astype(int))
        print(f"x1/4 {shape} smooth={smooth}: {(diff > 0).sum()} of {diff.size} off, "
              f"max {diff.max()}")
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_bicubic_other_sizes_within_one_of_cv2():
    rng = np.random.default_rng(1)
    for (h, w), size in (((100, 120), (300, 256)), ((201, 199), (256, 256)),
                         ((37, 53), (13, 9)), ((64, 64), (256, 256))):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        diff = np.abs(cv_compat.resize_cubic(img, size).astype(int)
                      - cv2.resize(img, size, interpolation=cv2.INTER_CUBIC).astype(int))
        print(f"{(h, w)} -> {size}: {(diff > 0).sum()} of {diff.size} off, max {diff.max()}")
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("jitter", [0.0, 1.0])
def test_paired_transform_equals_jax(jitter):
    rng = np.random.default_rng(3)
    kw = dict(hr_patch_size=32, scale_factor=4, color_jitter_prob=jitter)
    ours = PairedTransform(rng=np.random.default_rng(11), **kw)
    theirs = JaxPairedTransform(rng=np.random.default_rng(11), **kw)
    for _ in range(6):
        hr = _face(rng, 40, 48)
        lr = cv2.resize(hr, (12, 10), interpolation=cv2.INTER_CUBIC)
        a, b = ours(hr, lr), theirs(hr, lr)
        for x, y in zip(a, b):
            assert x.shape == y.shape and np.array_equal(x, y)


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    """train/HR (HR-only), val/HR + val/LR, and an HR+LR train split, of
    PNGs written by cv2 (the JAX package's writer)."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(5)
    for split, n, with_lr in (("train", 10, False), ("val", 5, True), ("paired", 6, True)):
        (root / split / "HR").mkdir(parents=True)
        if with_lr:
            (root / split / "LR").mkdir()
        for i in range(n):
            hr = _face(rng, 40, 44)
            cv2.imwrite(str(root / split / "HR" / f"{i:03d}.png"), hr[..., ::-1])
            if with_lr:
                lr = cv2.resize(hr, (11, 10), interpolation=cv2.INTER_CUBIC)
                cv2.imwrite(str(root / split / "LR" / f"{i:03d}.png"), lr[..., ::-1])
    return root


def _assert_batches(got, want, jitter):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in ("hr", "lr"):
            diff = np.abs(a[k] - b[k]) * 255
            if jitter:  # within the HSV limit: one level, rarely
                assert diff.max() <= 1 + 1e-3 and (diff > 0.5).mean() <= 1e-3
            else:
                assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("workers", [0, 1])
@pytest.mark.parametrize("mode,jitter", [("train", 0.0), ("train", 0.5), ("val", 0.3)])
def test_get_dataloader_equals_jax(png_root, mode, jitter, workers):
    kw = dict(mode=mode, batch_size=3, num_workers=workers, hr_patch_size=32, seed=42,
              color_jitter_prob=jitter)
    _assert_batches(list(get_dataloader(str(png_root), **kw)),
                    list(jax_get_dataloader(str(png_root), **kw)), jitter and mode == "train")


def test_paired_directories_equal_jax(png_root, tmp_path):
    # the HR/ + LR/ backend on a train split, through the dataset directly
    root = tmp_path / "p"
    root.mkdir()
    (root / "train").symlink_to(png_root / "paired")
    ours = FFHQDataset(str(root), hr_patch_size=32, seed=1, color_jitter_prob=0.0,
                       return_filename=True)
    theirs = JaxDataset(str(root), hr_patch_size=32, seed=1, color_jitter_prob=0.0,
                        return_filename=True)
    assert not ours.hr_only_mode and len(ours) == len(theirs) == 6
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["filename"] == b["filename"]
        assert np.array_equal(a["hr"], b["hr"]) and np.array_equal(a["lr"], b["lr"])


def test_fast_loader_equals_jax(png_root, tmp_path):
    for crop in (32, 48):  # 48 > 40: every image takes the bicubic upscale
        ours = FastHRLoader(FFHQDataset(str(png_root), hr_patch_size=crop), batch_size=4,
                            crop=crop, num_workers=2, seed=7)
        theirs = JaxFastHRLoader(JaxDataset(str(png_root), hr_patch_size=crop), batch_size=4,
                                 crop=crop, num_workers=2, seed=7)
        for _ in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                diff = np.abs(a["hr"] - b["hr"]) * 255
                assert diff.max() <= 1 + 1e-3 and (diff > 0.5).mean() <= 1e-2
                if crop == 32:
                    assert np.array_equal(a["hr"], b["hr"])


def test_native_assembler_equals_numpy_and_jax():
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (30 + i, 28 + 2 * i, 3), np.uint8) for i in range(5)]
    tops = np.array([0, 1, 2, 3, 4], np.int32)
    lefts = np.array([4, 3, 2, 1, 0], np.int32)
    flips = np.array([0, 1, 0, 1, 1], np.uint8)
    got = native.assemble_hr_batch(images, 24, tops, lefts, flips, nthreads=3)
    assert np.array_equal(got, native.assemble_hr_batch_numpy(images, 24, tops, lefts, flips))
    assert np.array_equal(got, jnative.assemble_hr_batch(images, 24, tops, lefts, flips))
    with pytest.raises(ValueError, match="cannot supply"):
        native.assemble_hr_batch(images, 31, tops, lefts, flips)


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    (tmp_path / "png_unfilter.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed to build png_unfilter"):
        native.load("png_unfilter")
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_dataset_refusals(png_root, tmp_path):
    dup = tmp_path / "dup"
    for sub in ("HR", "LR"):
        (dup / sub).mkdir(parents=True)
    img = _face(np.random.default_rng(0), 16, 16)
    for name in ("a.png", "a.jpg", "b.png"):
        cv2.imwrite(str(dup / "HR" / name), img)
        cv2.imwrite(str(dup / "LR" / name), img)
    with pytest.raises(ValueError, match="Duplicate image stems"):
        FFHQDataset(str(dup))
    (tmp_path / "data.h5").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="HDF5"):
        FFHQDataset(str(tmp_path / "data.h5"))
    jpg = tmp_path / "jpg" / "HR"
    jpg.mkdir(parents=True)
    cv2.imwrite(str(jpg / "face.jpg"), img)
    with pytest.raises(IOError, match="face.jpg"):
        FFHQDataset(str(tmp_path / "jpg"), hr_patch_size=8)[0]


def test_image_cache_and_sharding():
    cache = ImageCache(max_size=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1
    cache.put("c", 3)  # evicts b, the least recently used
    assert cache.get("b") is None and cache.get("c") == 3
    assert cache.hit_rate == pytest.approx(2 / 3)
    order = np.random.default_rng(0).permutation(23)
    for p in range(3):
        assert np.array_equal(host_shard(order, p, 3), jax_host_shard(order, p, 3))
    assert np.array_equal(host_shard(order), order)  # no process group: (0, 1)

    class Seq:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return {"x": np.array([i])}

    loader = DataLoader(Seq(), batch_size=3, drop_last=True, num_workers=0,
                        process_index=1, process_count=2)
    assert len(loader) == 1 and list(loader)[0]["x"].ravel().tolist() == [5, 6, 7]
