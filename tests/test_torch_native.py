"""Port parity: the port's build of the native library and ``ops.image``
(native, else Pillow) against ``cnn_sr_tpu.native`` and Pillow, on the CPU."""

import glob
import hashlib
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from cnn_sr_tpu import native as jnative
from cnn_sr_tpu_torch import native
from cnn_sr_tpu_torch.ops import image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_IMAGES = sorted(glob.glob(os.path.join(ROOT, "tests", "refdata", "*.png"))
                    + glob.glob(os.path.join(ROOT, "tests", "refdata", "*.jpg"))
                    + [os.path.join(ROOT, "tests", "golden", "upscale_9-1-5_seed1234.png")])
JAX_LIB = os.path.join(ROOT, "native", "libcnnsr_native.so")


def _rgb(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_builds_its_own_library_into_the_build_dir():
    info = native.build()
    path = os.path.realpath(info["path"])
    assert path.startswith(os.path.join(ROOT, "build", "cnn_sr_tpu_torch") + os.sep)
    assert os.path.isfile(path) and os.path.isfile(os.path.splitext(path)[0] + ".log")
    assert info["log"].startswith("g++ ") and "-march" not in info["log"]
    assert native.available() and native.build_error() is None
    assert image.codec().startswith("native (")


def test_import_and_use_leave_the_jax_library_alone():
    """The port never loads, makes or overwrites native/libcnnsr_native.so."""
    before = (os.stat(JAX_LIB).st_mtime_ns, hashlib.sha256(open(JAX_LIB, "rb").read()).digest())
    code = textwrap.dedent("""
        from cnn_sr_tpu_torch import native
        assert native.available()
        native.format_floats([1.0])
        maps = open("/proc/self/maps").read()
        assert "libcnnsr_native.so" not in maps, "the JAX package's library was loaded"
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    after = (os.stat(JAX_LIB).st_mtime_ns, hashlib.sha256(open(JAX_LIB, "rb").read()).digest())
    assert after == before


@pytest.mark.parametrize("path", REF_IMAGES, ids=os.path.basename)
def test_decode_bit_equal_to_jax_native(path):
    got = native.decode_rgba(path)
    np.testing.assert_array_equal(got, jnative.decode_rgba(path))
    np.testing.assert_array_equal(image.load_image(path), got)
    assert native.image_size(path) == jnative.image_size(path)


def test_png_roundtrip_bit_exact_and_jpeg_within_bound(tmp_path):
    rgb = _rgb((37, 53, 3), 2)
    p = str(tmp_path / "out.png")
    image.write_image(p, rgb)
    np.testing.assert_array_equal(image.load_image(p)[..., :3], rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), rgb)

    # tests/test_native.py's JPEG bound: mean |error| < 6 on a smooth image
    y = np.linspace(0, 255, 24, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 255, 32, dtype=np.float32)[None, :, None]
    smooth = np.clip((y + x) / 2 + np.random.default_rng(3).normal(0, 2, (24, 32, 3)),
                     0, 255).astype(np.uint8)
    pj = str(tmp_path / "out.jpg")
    native.encode_jpeg(pj, smooth, quality=95)
    back = image.load_image(pj)[..., :3].astype(np.int32)
    assert np.abs(back - smooth.astype(np.int32)).mean() < 6.0
    np.testing.assert_array_equal(back, jnative.decode_rgba(pj)[..., :3])


def test_extract_luma_and_sample_batch_equal_jax(tmp_path):
    rgba = _rgb((25, 31, 4), 3)
    for zm in (False, True):
        np.testing.assert_array_equal(native.extract_luma(rgba, True, zm),
                                      jnative.extract_luma(rgba, True, zm))
    paths = []
    for i in range(5):
        p = str(tmp_path / f"s{i}.png")
        Image.fromarray(_rgb((16, 22, 3), 10 + i), "RGB").save(p)
        paths.append(p)
    for zm in (False, True):
        np.testing.assert_array_equal(
            native.load_sample_batch(paths, 22, 16, subtract_mean=zm),
            jnative.load_sample_batch(paths, 22, 16, subtract_mean=zm))
    with pytest.raises(IOError):
        native.load_sample_batch(paths, 21, 16)


def test_float_codec_strings_identical():
    vals = np.random.default_rng(5).standard_normal(5000).astype(np.float32) * 1e3
    vals[:4] = [0.0, -0.0, 1e-38, 3.4e38]
    text = native.format_floats(vals)
    assert text == jnative.format_floats(vals)
    np.testing.assert_array_equal(native.parse_floats(text, vals.size), vals)
    with pytest.raises(ValueError):
        native.parse_floats(text, vals.size + 1)


def _without_native(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", "g++ failed (1): fatal error: jpeglib.h: "
                        "No such file or directory")
    assert not native.available()


@pytest.mark.parametrize("mode,shape", [("L", (19, 23)), ("LA", (19, 23, 2)),
                                        ("RGB", (21, 17, 3)), ("RGBA", (21, 17, 4))])
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_pillow_written_pngs_decode_alike_on_both_codecs(tmp_path, monkeypatch, mode, shape,
                                                         content):
    """Pillow's encoder picks its row filters adaptively, so its files
    hold all five filters: smooth content favours Sub, Up, Average and
    Paeth, noise None. The native decode and the Pillow fallback give the
    same RGBA."""
    arr = _rgb(shape, 7)
    if content == "smooth":
        yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
        ramp = (3 * yy + 5 * xx).astype(np.uint8)
        arr = ramp if arr.ndim == 2 else np.stack([ramp + 40 * c for c in range(shape[2])], -1)
    p = str(tmp_path / "p.png")
    Image.fromarray(arr.astype(np.uint8), mode).save(p)
    want = native.decode_rgba(p)
    np.testing.assert_array_equal(want, np.asarray(Image.open(p).convert("RGBA")))
    np.testing.assert_array_equal(image.load_image(p), want)
    _without_native(monkeypatch)
    np.testing.assert_array_equal(image.load_image(p), want)


def test_native_decoder_takes_all_five_filters(tmp_path):
    rgb = _rgb((6, 7, 3), 8)
    p = str(tmp_path / "f.png")
    native.encode_png(p, rgb)
    data = open(p, "rb").read()
    # re-filter the rows of the written file with filters 0..4 in turn
    import struct
    import zlib

    stride, bpp = 7 * 3, 3
    rows = rgb.reshape(6, stride).astype(np.int32)
    raw = bytearray()
    for y in range(6):
        k = y % 5
        prior = rows[y - 1] if y else np.zeros(stride, np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), rows[y][:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if k == 0:
            pred = np.zeros(stride, np.int32)
        elif k == 1:
            pred = left
        elif k == 2:
            pred = prior
        elif k == 3:
            pred = (left + prior) // 2
        else:
            pa, pb, pc = (np.abs(prior - ul), np.abs(left - ul),
                          np.abs(left + prior - 2 * ul))
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        raw.append(k)
        raw.extend(((rows[y] - pred) & 0xFF).astype(np.uint8).tobytes())
    head = data[:8 + 25]
    body = zlib.compress(bytes(raw))
    idat = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
        ">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF)
    iend = data[-12:]
    open(p, "wb").write(head + idat + iend)
    np.testing.assert_array_equal(native.decode_rgba(p)[..., :3], rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), rgb)


def test_trns_and_palette_files_decode_like_pillow(tmp_path):
    rgb = _rgb((8, 8, 3), 4)
    rgb[2, 3] = (10, 20, 30)
    p = str(tmp_path / "t.png")
    Image.fromarray(rgb, "RGB").save(p, transparency=(10, 20, 30))
    got = image.load_image(p)
    np.testing.assert_array_equal(got, np.asarray(Image.open(p).convert("RGBA")))
    assert got[2, 3, 3] == 0
    pal = str(tmp_path / "pal.png")
    Image.fromarray(rgb, "RGB").convert("P").save(pal)
    np.testing.assert_array_equal(image.load_image(pal),
                                  np.asarray(Image.open(pal).convert("RGBA")))


def test_without_the_native_library_pillow_serves(tmp_path, monkeypatch):
    """Where the library does not build (the card has no libpng or libjpeg
    headers), ``codec()`` names Pillow with the reason, PNG reads and
    writes through it bit for bit, the greyscale writer matches the JAX
    package's, and without Pillow too the error names what is missing."""
    rgb = _rgb((30, 41, 3), 9)
    _without_native(monkeypatch)
    assert re.match(r"Pillow \S+ \(the native library did not build: g\+\+ failed",
                    image.codec())
    p = str(tmp_path / "z.png")
    image.write_image(p, rgb)
    np.testing.assert_array_equal(image.load_image(p)[..., :3], rgb)
    monkeypatch.setattr(native, "_BUILD_ERROR", None)
    np.testing.assert_array_equal(native.decode_rgba(p)[..., :3], rgb)
    _without_native(monkeypatch)
    from cnn_sr_tpu.ops.image import write_greyscale_image

    data = np.random.default_rng(4).standard_normal((13, 17)).astype(np.float32)
    image.write_greyscale_image(str(tmp_path / "g.png"), data)
    write_greyscale_image(str(tmp_path / "gj.png"), data)
    np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / "g.png"))),
                                  np.asarray(Image.open(str(tmp_path / "gj.png"))))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert image.codec().startswith("none (Pillow is not installed) (the native library")
    with pytest.raises(IOError, match="libpng, libjpeg.*Pillow is not installed"):
        image.write_image(str(tmp_path / "z.jpg"), rgb)
    with pytest.raises(IOError, match="libpng, libjpeg.*Pillow is not installed"):
        image.load_image(p)


def test_library_key_names_the_compiler_and_a_foreign_copy_is_rebuilt(monkeypatch, tmp_path):
    """The build's name changes with the compiler, and a library in the
    build directory that does not load (built on another machine) is
    built again once rather than cached as a failure."""
    base = native.library_path()
    monkeypatch.setenv("CXX", "clang++-none")
    assert native.library_path() != base
    monkeypatch.delenv("CXX")
    assert native.library_path() == base

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", None)
    foreign = native.library_path()
    foreign.write_bytes(b"not a shared object")
    assert native.available(), native.build_error()
    assert foreign.read_bytes()[:4] == b"\x7fELF"
