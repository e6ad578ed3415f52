"""The port's HDF5 dataset path on the CPU, against h5py 3.14 and the JAX
package: the reader and writer of `facesr_torch.data.hdf5`, the ``.h5``
backend of `FFHQDataset`, the native fast loader and dp shards over an
``.h5`` root, ``prepare_data --hdf5``, the train CLI and the rehearsal on
``.h5`` files, and the committed fixtures the card checks against.

Tolerances: none. Arrays, filenames, attributes, chunk payloads, samples,
batches and losses are compared bitwise.
"""

import hashlib
import json
import sys
import threading
import zlib
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
import torch

from facesr.data.dataset import FFHQDataset as JaxDataset
from facesr.data.prepare_data import save_to_hdf5 as jax_save_to_hdf5
from facesr_torch.data import hdf5
from facesr_torch.data import prepare_data as tprep
from facesr_torch.data.dataset import FFHQDataset
from facesr_torch.data.fast_loader import FastHRLoader
from facesr_torch.parallel.mesh import NotPorted

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "hdf5"
# the stage-1 YAML cut to a tiny model (as tests/test_torch_train_cli.py cuts it)
TINY = (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 1"),
        ("blocks_per_group: 10", "blocks_per_group: 2"), ("num_workers: 16", "num_workers: 1"),
        ("hr_patch_size: 256", "hr_patch_size: 32"))
sys.path.insert(0, str(FIXTURES))
import make_hdf5_fixtures as fx  # noqa: E402


def _smooth(rng, size: int) -> np.ndarray:
    lo = (rng.random((5, 5, 3)) * 255).astype(np.uint8)
    img = cv2.resize(lo, (size, size), interpolation=cv2.INTER_CUBIC).astype(int)
    img[: size // 4] += rng.integers(-30, 30, (size // 4, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _split(root: Path, n: int, hr: int, lr: int, seed: int = 0) -> Path:
    """A processed split: HR/ and LR/ PNG pairs as cv2 writes them."""
    rng = np.random.default_rng(seed)
    (root / "HR").mkdir(parents=True)
    (root / "LR").mkdir()
    for i in range(n):
        img = _smooth(rng, hr)
        cv2.imwrite(str(root / "HR" / f"f{i:03d}.png"), img[..., ::-1])
        cv2.imwrite(str(root / "LR" / f"f{i:03d}.png"),
                    cv2.resize(img, (lr, lr), interpolation=cv2.INTER_AREA)[..., ::-1])
    return root


def _same_as_h5py(port_path: Path, h5py_path: Path) -> None:
    """The port's reader on ``port_path`` gives what h5py gives on
    ``h5py_path``: every dataset's array, dtype and layout, the attributes."""
    with hdf5.H5File(port_path) as f, h5py.File(h5py_path, "r") as g:
        assert f.keys() == sorted(g.keys()) == ["HR", "LR", "filenames"]
        for k in g:
            a, b = f[k].read(), g[k][:]
            assert a.dtype == b.dtype and a.shape == b.shape == f[k].shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert (f[k].chunks, f[k].compression, f[k].compression_opts) == \
                (g[k].chunks, g[k].compression, g[k].compression_opts), k
        for i in range(len(g["HR"])):
            np.testing.assert_array_equal(f["HR"][i], g["HR"][i])
            np.testing.assert_array_equal(f["LR"][i], g["LR"][i])
        assert f.attrs == {k: int(v) for k, v in g.attrs.items()}
        assert all(type(v) is np.int64 for v in g.attrs.values())


# ---------------------------------------------------------------------------
# the reader against h5py


@pytest.mark.parametrize("n,hr,lr", [(6, 64, 16), (2, 256, 64)])
def test_reader_equals_h5py_on_files_from_the_jax_save_to_hdf5(tmp_path, n, hr, lr):
    split = _split(tmp_path / "split", n, hr, lr, seed=hr)
    jax_save_to_hdf5(split, tmp_path / "jax.h5", hr, lr)
    _same_as_h5py(tmp_path / "jax.h5", tmp_path / "jax.h5")


DIGESTS = json.loads((FIXTURES / "digests.json").read_text())


def _port_digest(path: Path) -> dict:
    with hdf5.H5File(path) as f:
        out = {k: {"shape": list(f[k].shape),
                   "sha256": hashlib.sha256(f[k].read().tobytes()).hexdigest()}
               for k in ("HR", "LR")}
        out["filenames"] = hashlib.sha256(b"\n".join(f["filenames"][:].tolist())).hexdigest()
        out["attrs"] = dict(sorted(f.attrs.items()))
    return out


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests_are_h5pys_and_the_ports(name):
    assert fx.digest(FIXTURES / name) == DIGESTS[name]
    assert _port_digest(FIXTURES / name) == DIGESTS[name]


def test_the_4200_chunk_fixture_has_a_three_level_chunk_tree():
    """Its chunk index is three levels deep, as FFHQ's 60,000-image train
    split's would be; the reader walks every level."""
    with hdf5.H5File(FIXTURES / "chunks_4200.h5") as f:
        for k in ("HR", "LR"):
            ds = f[k]
            assert ds.shape[0] == 4200
            root = f.rd.read(ds._btree, 8, "root")
            assert root[:4] == b"TREE" and root[5] == 2, k  # level 2: three levels
            assert (ds._chunk_index()[:, 0] >= 0).all()
    _same_as_h5py(FIXTURES / "chunks_4200.h5", FIXTURES / "chunks_4200.h5")


def test_threads_share_one_reader():
    """Loader threads read chunks through one descriptor (pread) and get
    what one thread gets."""
    with hdf5.H5File(FIXTURES / "chunks_4200.h5") as f:
        want = f["HR"].read()
        got = np.zeros_like(want)

        def work(k):
            for i in range(k, 4200, 8):
                got[i] = f["HR"].image(i)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the writer against h5py


def test_writer_is_read_by_h5py_and_the_jax_dataset_as_h5pys_own_file(tmp_path):
    split = _split(tmp_path / "split", 5, 64, 16, seed=1)
    jax_save_to_hdf5(split, tmp_path / "jax.h5", 64, 16)
    tprep.save_to_hdf5(split, tmp_path / "port.h5", 64, 16)
    with h5py.File(tmp_path / "port.h5", "r") as f, h5py.File(tmp_path / "jax.h5", "r") as g:
        assert sorted(f.keys()) == sorted(g.keys())
        for k in g:
            assert (f[k].shape, f[k].dtype, f[k].chunks, f[k].compression,
                    f[k].compression_opts) == (g[k].shape, g[k].dtype, g[k].chunks,
                                               g[k].compression, g[k].compression_opts), k
            np.testing.assert_array_equal(f[k][:], g[k][:], err_msg=k)
        assert f["HR"].compression == "gzip" and f["HR"].compression_opts == 4
        assert dict(f.attrs) == dict(g.attrs)
        assert all(type(v) is np.int64 for v in f.attrs.values())
        for k in ("HR", "LR"):
            assert f[k].id.get_num_chunks() == g[k].id.get_num_chunks() == 5
            for i in range(5):
                mine, theirs = (h[k].id.read_direct_chunk((i, 0, 0, 0)) for h in (f, g))
                assert mine == theirs, (k, i)
    for mode in ("train", "val"):
        kw = dict(mode=mode, hr_patch_size=32, use_cache=False, seed=4, return_filename=True)
        ours, theirs = JaxDataset(str(tmp_path / "port.h5"), **kw), \
            JaxDataset(str(tmp_path / "jax.h5"), **kw)
        for i in range(5):
            a, b = ours[i], theirs[i]
            assert a["filename"] == b["filename"]
            for k in ("hr", "lr"):
                np.testing.assert_array_equal(a[k], b[k])
    _same_as_h5py(tmp_path / "port.h5", tmp_path / "jax.h5")


def test_writer_builds_a_deep_chunk_tree_h5py_reads(tmp_path):
    rng = np.random.default_rng(2)
    hrs = rng.integers(0, 256, (4200, 4, 4, 3), dtype=np.uint8)
    lrs = hrs[:, :1, :1]
    pairs = ((hrs[i], lrs[i], f"{i:05d}.png") for i in range(4200))
    assert hdf5.write_pairs(tmp_path / "deep.h5", pairs, 4, 1) == 4200
    with h5py.File(tmp_path / "deep.h5", "r") as g:
        np.testing.assert_array_equal(g["HR"][:], hrs)
        np.testing.assert_array_equal(g["LR"][:], lrs)
        assert g["HR"].id.get_num_chunks() == 4200
        assert g["HR"].id.read_direct_chunk((4199, 0, 0, 0))[1] == \
            zlib.compress(hrs[4199].tobytes(), 4)
        assert g["filenames"][4199] == b"04199.png"
    with hdf5.H5File(tmp_path / "deep.h5") as f:
        assert f.rd.read(f["HR"]._btree, 8, "root")[5] == 2
        np.testing.assert_array_equal(f["HR"].read(), hrs)


def test_save_to_hdf5_checks_and_errors_match_jax(tmp_path):
    split = _split(tmp_path / "split", 2, 32, 8)
    for fn in (jax_save_to_hdf5, tprep.save_to_hdf5):  # the sizes given are wrong
        with pytest.raises(ValueError, match="f000.png: sizes .* do not match hr_size=64/lr_size"
                                             "=16"):
            fn(split, tmp_path / "x.h5", 64, 16)
    (split / "LR" / "f001.png").unlink()
    for fn in (jax_save_to_hdf5, tprep.save_to_hdf5):
        with pytest.raises(IOError, match="Unreadable/missing pair for f001.png \\(LR exists: "
                                          "False\\)"):
            fn(split, tmp_path / "x.h5", 32, 8)
    empty = tmp_path / "empty"
    (empty / "HR").mkdir(parents=True)
    for fn in (jax_save_to_hdf5, tprep.save_to_hdf5):  # h5py refuses an empty chunked set
        with pytest.raises(ValueError, match="Chunk shape must not be greater than data shape"):
            fn(empty, tmp_path / "e.h5", 32, 8)
    with pytest.raises(ValueError, match="HR is uint8 \\(8, 8, 3\\), want uint8 \\(4, 4, 3\\)"):
        hdf5.write_pairs(tmp_path / "w.h5", [(np.zeros((8, 8, 3), np.uint8),
                                              np.zeros((1, 1, 3), np.uint8), "a.png")], 4, 1)


# ---------------------------------------------------------------------------
# refusals by name, and faults


def _h5py_file(path: Path, case: str) -> None:
    data = np.ones((2, 8, 8, 3), np.uint8)
    kw = dict(chunks=(1, 8, 8, 3), compression="gzip")
    with h5py.File(path, "w", libver="latest" if case == "latest" else None) as f:
        if case == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"HR", h5py.h5t.STD_U8LE, h5py.h5s.create_simple(data.shape),
                            dcpl=dcpl)
        elif case == "float32":
            f.create_dataset("HR", data=data.astype(np.float32), **kw)
        else:
            extra = {"shuffle": dict(shuffle=True), "fletcher32": dict(fletcher32=True)}
            f.create_dataset("HR", data=data, **kw, **extra.get(case, {}))
        if case == "mask":  # chunk 1 stored raw, its filter mask skipping deflate
            f["HR"].id.write_direct_chunk((1, 0, 0, 0), data[1].tobytes(), filter_mask=1)
        f.create_dataset("filenames", data=np.array([b"a.png", b"b.png"]))
        f.attrs["hr_size"] = 8


@pytest.mark.parametrize("case,what", [
    ("latest", "superblock version 3 \\(h5py's libver='latest'\\)"),
    ("shuffle", "the shuffle filter"), ("fletcher32", "the Fletcher-32 filter"),
    ("float32", "a floating-point datatype of 4 bytes"), ("compact", "a compact layout"),
    ("mask", "chunk 1's filter mask skips deflate")])
def test_layouts_h5py_writes_but_the_port_does_not_read_are_refused_by_name(tmp_path, case,
                                                                            what):
    path = tmp_path / f"{case}.h5"
    _h5py_file(path, case)
    with h5py.File(path, "r") as g:  # h5py reads each one
        assert g["HR"].shape == (2, 8, 8, 3)
    with pytest.raises(hdf5.UnsupportedHDF5, match=f"{case}.h5: .*{what}") as e:
        with hdf5.H5File(path) as f:
            f["HR"].image(1)
    assert isinstance(e.value, NotPorted) and isinstance(e.value, hdf5.HDF5Error)
    with pytest.raises(hdf5.UnsupportedHDF5, match=what):  # and the dataset on it
        FFHQDataset(str(path), mode="val", hr_patch_size=8).load_hr(1)


def test_truncated_and_corrupt_files_raise_hdf5_error(tmp_path):
    data = (FIXTURES / "faces_256.h5").read_bytes()
    (tmp_path / "cut.h5").write_bytes(data[:len(data) // 2])
    with pytest.raises(hdf5.HDF5Error, match="cut.h5: truncated") as e:
        hdf5.H5File(tmp_path / "cut.h5")
    assert not isinstance(e.value, NotPorted)
    bad = bytearray(data)
    with hdf5.H5File(FIXTURES / "faces_256.h5") as f:
        addr, size = f["HR"]._chunk_index()[1]
    bad[addr + 10:addr + 20] = bytes(10)  # a chunk whose deflate stream is broken
    (tmp_path / "bad.h5").write_bytes(bytes(bad))
    with hdf5.H5File(tmp_path / "bad.h5") as f:
        f["HR"].image(0)
        with pytest.raises(hdf5.HDF5Error, match="bad.h5: dataset 'HR': chunk 1"):
            f["HR"].image(1)
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        hdf5.H5File(FIXTURES / "make_hdf5_fixtures.py")


# ---------------------------------------------------------------------------
# the dataset, the loaders, the CLIs


@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    """A processed folder as ``prepare_data --hdf5`` leaves it: train/ and
    val/ PNG pairs, and train.h5 / val.h5 packed from them by the JAX
    ``save_to_hdf5``; and a second folder whose PNGs differ from the .h5
    files (``decoy``: the .h5 must win there)."""
    root = tmp_path_factory.mktemp("h5root")
    (root / "h5").mkdir()
    for mode, n, seed in (("train", 8, 5), ("val", 3, 6)):
        _split(root / "pngs" / mode, n, 48, 12, seed=seed)
        jax_save_to_hdf5(root / "pngs" / mode, root / "h5" / f"{mode}.h5", 48, 12)
        _split(root / "decoy" / mode, n, 48, 12, seed=seed + 10)
        (root / "decoy" / f"{mode}.h5").write_bytes((root / "h5" / f"{mode}.h5").read_bytes())
    return root


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("where", ["file", "folder"])
def test_dataset_over_h5_equals_jax(h5_root, where, mode):
    root = str(h5_root / "h5" / f"{mode}.h5") if where == "file" else str(h5_root / "decoy")
    kw = dict(mode=mode, hr_patch_size=32, use_cache=False, seed=7, return_filename=True)
    ours, theirs = FFHQDataset(root, **kw), JaxDataset(root, **kw)
    assert ours.use_hdf5 and len(ours) == len(theirs)
    assert ours.filenames == theirs.filenames
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["filename"] == b["filename"]
        for k in ("hr", "lr"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {mode} {i} {k}")
        np.testing.assert_array_equal(ours.load_hr(i), theirs.load_hr(i))
    pngs = FFHQDataset(str(h5_root / "decoy"), mode=mode, use_cache=False)
    assert not np.array_equal(pngs.load_hr(0), FFHQDataset(
        str(h5_root / "decoy" / mode), mode=mode, use_cache=False).load_hr(0))  # .h5 won


def test_dataset_with_the_cache_and_no_filenames(tmp_path):
    with h5py.File(tmp_path / "nf.h5", "w") as f:  # no filenames: 00000.png ...
        f.create_dataset("HR", data=np.arange(2 * 8 * 8 * 3, dtype=np.uint8).reshape(2, 8, 8, 3),
                         chunks=(1, 8, 8, 3), compression="gzip")
        f.create_dataset("LR", data=np.ones((2, 2, 2, 3), np.uint8), chunks=(1, 2, 2, 3),
                         compression="gzip")
    kw = dict(hr_patch_size=8, seed=1, return_filename=True)
    ours, theirs = FFHQDataset(str(tmp_path / "nf.h5"), **kw), JaxDataset(str(tmp_path / "nf.h5"),
                                                                           **kw)
    assert ours.filenames == theirs.filenames == ["00000.png", "00001.png"]
    for _ in range(2):  # the second pass through the cache
        for i in range(2):
            a, b = ours[i], theirs[i]
            assert a["filename"] == b["filename"]
            for k in ("hr", "lr"):
                np.testing.assert_array_equal(a[k], b[k])
    assert ours.cache.hits == theirs.cache.hits == 2


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
def test_fast_loader_gives_the_same_batches_over_h5_as_over_pngs(h5_root, shard):
    """The native HR-only loader reads `load_hr` from the .h5 file; each dp
    rank (its own dataset, so its own descriptor) takes its shard."""
    index, count = shard or (None, None)

    def batches(root):
        ds = FFHQDataset(str(root), mode="train", hr_patch_size=32)
        loader = FastHRLoader(ds, batch_size=2, crop=32, seed=3, num_workers=2,
                              process_index=index, process_count=count)
        return ds, [b["hr"] for _ in range(2) for b in loader]

    ds_h5, got = batches(h5_root / "h5")
    ds_png, want = batches(h5_root / "pngs")
    assert ds_h5.use_hdf5 and not ds_png.use_hdf5
    assert len(got) == len(want) == (4 if shard else 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_prepare_data_hdf5_equals_the_jax_cli(tmp_path, monkeypatch):
    from facesr.data import prepare_data as jprep

    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(9)
    for i in range(10):
        cv2.imwrite(str(raw / f"im_{i:02d}.png"), _smooth(rng, 80)[..., ::-1])
    argv = ["--input", str(raw), "--hr-size", "64", "--lr-size", "16", "--train-ratio", "0.6",
            "--val-ratio", "0.2", "--hdf5"]
    monkeypatch.setattr(sys, "argv", ["prepare_data.py", *argv, "--output", str(tmp_path / "jax")])
    jprep.main()
    assert tprep.main(argv + ["--output", str(tmp_path / "port")]) == {"train": 6, "val": 2,
                                                                       "test": 2}
    for split in ("train", "val", "test"):
        _same_as_h5py(tmp_path / "port" / f"{split}.h5", tmp_path / "jax" / f"{split}.h5")
        with h5py.File(tmp_path / "port" / f"{split}.h5", "r") as f, \
                h5py.File(tmp_path / "jax" / f"{split}.h5", "r") as g:
            for k in g:
                np.testing.assert_array_equal(f[k][:], g[k][:], err_msg=f"{split} {k}")
            assert dict(f.attrs) == dict(g.attrs)


@pytest.mark.parametrize("fast", [False, True])
def test_train_cli_one_epoch_on_h5_equals_the_png_folders(h5_root, tmp_path, monkeypatch,
                                                         fast):
    """The train CLI on a root holding train.h5 and val.h5 picks them with
    no flag and trains to the losses of the same run on the PNG folders
    they were packed from (plain and ``--fast-loader``)."""
    from facesr_torch.cli import train as train_cli

    text = (ROOT / "configs" / "stages" / "stage1_psnr_config.yaml").read_text()
    for old, new in TINY:
        assert old in text, old
        text = text.replace(old, new)
    (tmp_path / "stage1_psnr_config.yaml").write_text(text)
    opened = []
    real = hdf5.H5File.__init__

    def record(self, path):
        opened.append(Path(path).name)
        real(self, path)

    monkeypatch.setattr(hdf5.H5File, "__init__", record)
    monkeypatch.chdir(tmp_path)
    runs = {}
    for kind in ("h5", "pngs"):
        trainer = train_cli.run(["--config", "stage1_psnr_config.yaml", "--data-root",
                                 str(h5_root / kind), "--device", "cpu", "--epochs", "1",
                                 "--batch-size", "2"] + (["--fast-loader"] if fast else []))
        runs[kind] = {k: list(v) for k, v in trainer.training_history.items()}
        if kind == "h5":
            assert opened == ["train.h5", "val.h5"]
    assert runs["h5"] == runs["pngs"] and runs["h5"]["train_loss"]
