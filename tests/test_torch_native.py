"""The port's native image decoder (ddl_tpu_torch/native/) against PIL and
the JAX package's decoder (ddl_tpu/native/) on the same files, in both of
its builds: with libjpeg, and without it (the build a host without
libjpeg gets).  Also the data loader's native path, its PIL fallback and
their counters, a failed build's warning, and the PNG writer of
chip_smoke.py's phase 10."""

import struct
import sys
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from ddl_tpu import native as jax_native
from ddl_tpu_torch import native
from ddl_tpu_torch.data import AptosImageDataset, DataLoader, ShardedEpochSampler
from ddl_tpu_torch.data import SyntheticAptosDataset

H, W = 37, 53
VARIANTS = {"libjpeg": dict(libjpeg=True), "no-libjpeg": dict(libjpeg=False)}


@pytest.fixture(scope="session")
def libs():
    """Both builds, compiled once per session."""
    return {name: native.open_library(native.build(**kw)) for name, kw in VARIANTS.items()}


def _interlaced_png(img: np.ndarray) -> bytes:
    """``img`` (H, W, 3) uint8 as an Adam7-interlaced 8-bit RGB PNG, each
    pass's rows under filter 1 (Sub)."""
    rows = []
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                           (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub.reshape(sub.shape[0], -1).astype(np.int16):
            diff = row.copy()
            diff[3:] = row[3:] - row[:-3]
            rows.append(b"\x01" + (diff % 256).astype(np.uint8).tobytes())

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    h, w, _ = img.shape
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(b"".join(rows), 9)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """PNG files of every colour type and bit depth PIL writes, at zlib
    levels 0 (stored blocks), 1 and 9, an interlaced one, and two JPEGs:
    name -> path."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    smooth = np.linspace(0, 255, H * W * 3).reshape(H, W, 3).astype(np.uint8)
    images = {
        "rgb": (Image.fromarray(noise), {}), "smooth": (Image.fromarray(smooth), {}),
        "rgba": (Image.fromarray(np.dstack([noise, smooth[..., :1]]), "RGBA"), {}),
        "gray": (Image.fromarray(noise[..., 0]), {}),
        "gray-alpha": (Image.fromarray(noise[..., :2].copy(), "LA"), {}),
        "bilevel": (Image.fromarray(noise[..., 0] > 128), {}),
        "palette8": (Image.fromarray(smooth).quantize(200), {}),
        "palette4": (Image.fromarray(smooth).quantize(16), {"bits": 4}),
        "palette2": (Image.fromarray(smooth).quantize(4), {"bits": 2}),
        "palette1": (Image.fromarray(smooth).quantize(2), {"bits": 1}),
        "gray16": (Image.fromarray(noise[..., 0].astype(np.uint16) * 257 + 3), {}),
    }
    out = {}
    for name, (img, kw) in images.items():
        for level in (0, 1, 9):
            path = root / f"{name}-{level}.png"
            img.save(path, compress_level=level, **kw)
            out[f"{name}-{level}"] = path
    out["interlaced"] = root / "interlaced.png"
    out["interlaced"].write_bytes(_interlaced_png(noise))
    for name, img in (("rgb", noise), ("gray", noise[..., 0])):
        out[f"jpeg-{name}"] = root / f"{name}.jpg"
        Image.fromarray(img).save(out[f"jpeg-{name}"], quality=90)
    return out


def _pil(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _pngs(files):
    return {k: p for k, p in files.items() if p.suffix == ".png"}


@pytest.mark.parametrize("variant", VARIANTS)
def test_image_size_and_load_batch_equal_pil(libs, files, variant):
    """Every PNG decodes to PIL's RGB (16-bit gray aside: PIL clips it, the
    decoder keeps the high byte as libpng's strip_16 does, held below)."""
    lib = libs[variant]
    for name, path in _pngs(files).items():
        assert native.image_size(path, lib=lib) == (H, W), name
        if name.startswith("gray16"):
            continue
        got = native.load_batch([path], H, W, lib=lib)
        assert got is not None, name
        np.testing.assert_array_equal(got[0], _pil(path), err_msg=name)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bit_equal_to_the_jax_decoder(libs, files, variant):
    """The whole set as one batch, bit-equal to ``ddl_tpu.native.load_batch``;
    the JPEGs too where the build has libjpeg, and refused (None) where it
    has not."""
    lib = libs[variant]
    pngs = list(_pngs(files).values())
    got = native.load_batch(pngs, H, W, lib=lib)
    want = jax_native.load_batch(pngs, H, W)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    jpegs = [files["jpeg-rgb"], files["jpeg-gray"]]
    want = jax_native.load_batch(jpegs, H, W)
    if VARIANTS[variant]["libjpeg"]:
        np.testing.assert_array_equal(native.load_batch(jpegs, H, W, lib=lib), want)
    else:
        assert native.load_batch(jpegs, H, W, lib=lib) is None
        assert native.load_batch(jpegs[:1] + pngs[:1], H, W, lib=lib) is None


@pytest.mark.parametrize("variant", VARIANTS)
def test_gray_and_palette_promote_to_rgb(libs, files, variant):
    lib = libs[variant]
    for name in ("gray-9", "gray-alpha-1", "bilevel-0", "gray16-9"):
        img = native.load_batch([files[name]], H, W, lib=lib)[0]
        assert img.shape == (H, W, 3) and (img == img[..., :1]).all(), name
    bilevel = native.load_batch([files["bilevel-9"]], H, W, lib=lib)[0]
    assert set(np.unique(bilevel)) <= {0, 255}
    for bits in (1, 2, 4, 8):
        img = native.load_batch([files[f"palette{bits}-9"]], H, W, lib=lib)[0]
        with Image.open(files[f"palette{bits}-9"]) as im:
            pal = np.asarray(im.getpalette()[: 3 * 2 ** bits]).reshape(-1, 3)
            idx = np.asarray(im)
        np.testing.assert_array_equal(img, pal[idx])


@pytest.mark.parametrize("variant", VARIANTS)
def test_missing_wrong_size_or_torn_files_fail(libs, files, variant, tmp_path):
    lib = libs[variant]
    good = files["rgb-9"]
    torn = tmp_path / "torn.png"
    torn.write_bytes(good.read_bytes()[:-100])
    flipped = tmp_path / "flipped.png"
    data = bytearray(good.read_bytes())
    data[100] ^= 0xFF  # inside IDAT: the CRC no longer holds
    flipped.write_bytes(bytes(data))
    for path in (tmp_path / "missing.png", torn, flipped):
        assert native.load_batch([good, path], H, W, lib=lib) is None, path.name
    assert native.load_batch([good], H, W + 1, lib=lib) is None
    assert native.image_size(tmp_path / "missing.png", lib=lib) is None
    assert native.image_size(files["jpeg-rgb"], lib=lib) is None


@pytest.mark.parametrize("variant", VARIANTS)
def test_16_bit_keeps_the_high_byte_in_both_builds(libs, files, variant):
    got = native.load_batch([files["gray16-9"]], H, W, lib=libs[variant])[0]
    with Image.open(files["gray16-9"]) as im:
        high = (np.asarray(im).astype(np.uint16) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], high)


def _tree(root, n_train=12, n_test=7, size=24):
    train = SyntheticAptosDataset(n_train, size, 5, seed=1)
    test = SyntheticAptosDataset(n_test, size, 5, seed=2)
    chip_smoke.write_aptos_tree(root, train, test)
    return (AptosImageDataset(root / "train.csv", root / "train_images", "new_id_code"),
            AptosImageDataset(root / "test.csv", root / "test_images", "id_code"), train, test)


def _epoch(dataset, batch, pad=False):
    sampler = ShardedEpochSampler(len(dataset), shuffle=not pad, drop_last=not pad,
                                  pad_mode="sentinel" if pad else "wrap", seed=3)
    loader = DataLoader(dataset, batch, sampler=sampler, drop_last=not pad, num_workers=0,
                        pad_last_batch=pad)
    loader.set_epoch(1)
    return list(loader)


@pytest.mark.parametrize("pad", [False, True], ids=["train", "eval-padded"])
def test_loader_takes_the_native_path_and_matches_pil(tmp_path, monkeypatch, pad):
    """A file-backed dataset: every batch decoded natively (the counter),
    the same images and labels as with the decoder switched off (PIL, its
    counter) and as the in-memory set the files were written from."""
    train, test, mem_train, mem_test = _tree(tmp_path)
    ds, mem = (test, mem_test) if pad else (train, mem_train)
    monkeypatch.setattr(native, "batches", {"native": 0, "pil": 0})
    got = _epoch(ds, 5, pad)
    assert native.batches == {"native": len(got), "pil": 0}
    with monkeypatch.context() as m:
        m.setattr(native, "native_available", lambda: False)
        fallback = _epoch(ds, 5, pad)
    assert native.batches == {"native": len(got), "pil": len(got)}
    in_memory = _epoch(mem, 5, pad)
    assert native.batches["native"] == native.batches["pil"] == len(got)
    for (gi, gl), (fi, fl), (mi, ml) in zip(got, fallback, in_memory, strict=True):
        np.testing.assert_array_equal(gi, fi)
        np.testing.assert_array_equal(gi, mi)
        np.testing.assert_array_equal(gl, fl)
        np.testing.assert_array_equal(gl, ml)
        assert gl.dtype == np.int32


def test_failed_build_warns_once_and_falls_back_to_pil(tmp_path, monkeypatch):
    train, _, mem_train, _ = _tree(tmp_path / "tree", n_train=6)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "batches", {"native": 0, "pil": 0})
    with pytest.warns(RuntimeWarning, match="falls back to PIL") as record:
        assert native.loader_lib() is None
        assert native.loader_lib() is None
    assert len(record) == 1 and "no-such-compiler" in str(record[0].message)
    assert "no-such-compiler" in (tmp_path / "build" / "libddl_loader.log").read_text()
    got = _epoch(train, 3)
    assert native.batches == {"native": 0, "pil": 2}
    np.testing.assert_array_equal(got[0][0], _epoch(mem_train, 3)[0][0])


def _filters(png: bytes) -> set[int]:
    """The filter types of a non-interlaced PNG's rows."""
    pos, idat = 8, b""
    while pos < len(png):
        (n,), kind = struct.unpack(">I", png[pos:pos + 4]), png[pos + 4:pos + 8]
        idat += png[pos + 8:pos + 8 + n] if kind == b"IDAT" else b""
        pos += 12 + n
    w = struct.unpack(">I", png[16:20])[0]
    return set(zlib.decompress(idat)[::1 + 3 * w])


@pytest.mark.parametrize("kind", ["synthetic", "fundus-like"])
def test_phase_10_png_writer_round_trips_through_pil(tmp_path, libs, kind):
    """The writer's files (adaptive filters, 8 KiB IDAT chunks) read back
    bit-equal through PIL and the native decoder; the fundus-like images
    take all five filters."""
    imgs = (np.stack([SyntheticAptosDataset(2, 224, 5, seed=1)[i][0] for i in range(2)])
            if kind == "synthetic" else chip_smoke.fundus_like(2, 224, seed=3))
    paths = []
    for i, img in enumerate(imgs):
        paths.append(tmp_path / f"{i}.png")
        png = chip_smoke.png_bytes(img)
        paths[-1].write_bytes(png)
        assert png.count(b"IDAT") > 1
        if kind == "fundus-like":
            assert _filters(png) == {0, 1, 2, 3, 4}
        with Image.open(paths[-1]) as im:
            assert im.mode == "RGB" and im.size == (224, 224)
            np.testing.assert_array_equal(np.asarray(im), img)
    for lib in libs.values():
        np.testing.assert_array_equal(native.load_batch(paths, 224, 224, lib=lib), imgs)


def test_batch_counts_lose_no_update_across_threads(monkeypatch):
    """Loaders count from their producer threads: 16 threads x 2000
    counts, with a short switch interval, lose none."""
    monkeypatch.setattr(native, "batches", {"native": 0, "pil": 0})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda r=r: [native.count_batch(r)
                                                          for _ in range(2000)])
                   for r in ("native", "pil") * 8]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert native.batches == {"native": 16000, "pil": 16000}
