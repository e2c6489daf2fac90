"""The standard-library PNG codec (utils/png.py): round trips, every
colour type and row filter a PNG writer may use (cross-checked against
Pillow where it is installed), and the Pillow-free paths of the CLI and
the texture loader."""

import io
import subprocess
import sys
import zlib

import numpy as np
import pytest

from cs397raytracingsp22.utils import png


def _img(h=13, w=17, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", [(1, 1), (13, 17), (64, 3)])
def test_round_trip(tmp_path, shape):
    img = _img(*shape)
    path = tmp_path / "x.png"
    png.write_png(str(path), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


def _raw_png(rows_with_filters: bytes, w, h, ctype, plte=None):
    import struct

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    out = png._SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    return out + chunk(b"IDAT", zlib.compress(rows_with_filters)) + chunk(b"IEND", b"")


def _filter(rows: np.ndarray, ftype: int, bpp: int) -> bytes:
    """Encode (h, stride) uint8 rows with one PNG filter type."""
    h, stride = rows.shape
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_decodes_every_filter_and_colour_type(ftype, ctype):
    rng = np.random.default_rng(ftype * 10 + ctype)
    h, w = 9, 11
    ch = png._CHANNELS[ctype]
    px = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
    plte = None
    if ctype == 3:
        palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
        plte = palette.tobytes()
        want = palette[px[..., 0]]
    elif ch <= 2:
        want = np.repeat(px[..., :1], 3, axis=2)
    else:
        want = px[..., :3]
    data = _raw_png(_filter(px.reshape(h, w * ch), ftype, ch), w, h, ctype, plte)
    np.testing.assert_array_equal(png.decode_png(data), want)


def test_matches_pillow_encodings():
    Image = pytest.importorskip("PIL.Image")
    img = _img(20, 30, seed=3)
    for mode in ("RGB", "RGBA", "L", "LA"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, format="PNG", optimize=True)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        np.testing.assert_array_equal(png.decode_png(buf.getvalue()), want)
    # and Pillow reads what we write
    got = np.asarray(Image.open(io.BytesIO(png.encode_png(img))).convert("RGB"))
    np.testing.assert_array_equal(got, img)


def test_rejects_unsupported_png():
    data = _raw_png(b"\x00" + bytes(6), 3, 1, 2)
    bad = data.replace(b"IHDR" + data[16:24] + bytes([8]), b"IHDR" + data[16:24] + bytes([16]))
    with pytest.raises(ValueError):
        png.decode_png(bad)
    with pytest.raises(ValueError):
        png.decode_png(b"not a png at all")


def test_load_image_png_missing_and_decoder(tmp_path, monkeypatch):
    from cs397raytracingsp22.utils.texture import load_image

    img = _img()
    png.write_png(str(tmp_path / "t.png"), img)
    np.testing.assert_array_equal(load_image(str(tmp_path / "t.png")), img)
    # a missing file is the reference's graceful None (texture.rs:16-25)
    assert load_image(str(tmp_path / "absent.jpg")) is None
    # a present JPG without Pillow fails loudly instead of vanishing
    (tmp_path / "t.jpg").write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        load_image(str(tmp_path / "t.jpg"))


def test_cli_render_without_pillow(tmp_path):
    """A CPU render through cli.main with Pillow unimportable."""
    out = tmp_path / "r.png"
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from cs397raytracingsp22 import cli\n"
        f"sys.exit(cli.main(['scenes/cornell.py', '-o', {str(out)!r}, '-q',"
        " '--width', '8', '--height', '8', '--spp', '2', '--set', 'path_depth=2']))\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=600,
                   cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert png.read_png(str(out)).shape == (8, 8, 3)
