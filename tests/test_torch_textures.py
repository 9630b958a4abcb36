"""The port's textures (maniskill_tpu_torch/render/textures.py) and the
real-mesh YCB visual branch against the JAX package's, on small
``.obj``/``.mtl``/``.png`` files written into ``tmp_path``.

- ``checker``, ``speckle``, ``load_obj_with_uv``, ``load_image`` and
  ``bake_obj_face_colors`` within 1e-6 of the JAX functions (which read the
  texture with Pillow).
- The port's PNG reader (standard-library zlib) equal to Pillow's decode for
  8-bit colour types 0, 2, 3 and 6 under each of the five scanline filters
  and a mix of them; other formats go through Pillow, and without Pillow
  they give None as the JAX function does.
- ``load_model_visual`` with a ``textured.obj`` present (and decimated past
  ``max_faces``) equal to the JAX package's; with ``collision.ply`` present
  both packages raise ``ValueError`` (the mesh reader takes no ``.ply``).
"""
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from maniskill_tpu.building.actors import ycb as jycb
from maniskill_tpu.render import textures as jtex

from maniskill_tpu_torch.building.actors import ycb as tycb
from maniskill_tpu_torch.render import textures as ttex

ATOL = 1e-6


def test_procedural_images():
    for args in ((), (32, 4), (48, 6, (1, 0, 0), (0, 0, 1))):
        np.testing.assert_array_equal(ttex.checker(*args), jtex.checker(*args))
    for kw in ({}, dict(size=32, base=(0.2, 0.6, 0.4), amp=0.3, seed=5)):
        np.testing.assert_allclose(ttex.speckle(**kw), jtex.speckle(**kw), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ttex.wood(32, seed=2), jtex.wood(32, seed=2))


def _filter_row(kind, row, prev, bpp):
    """Apply PNG filter ``kind`` to one scanline (uint8 arrays)."""
    row, prev = row.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if kind == 0:
        out = row
    elif kind == 1:
        out = row - left
    elif kind == 2:
        out = row - prev
    elif kind == 3:
        out = row - (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        out = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return (out & 0xFF).astype(np.uint8)


def write_png(path, pixels, ctype, filters, palette=None):
    """A PNG with the given per-row filter types (cycled over the rows)."""
    h, w = pixels.shape[:2]
    bpp = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    rows = pixels.reshape(h, w * bpp)
    raw, prev = b"", np.zeros(w * bpp, np.uint8)
    for y in range(h):
        kind = filters[y % len(filters)]
        raw += bytes([kind]) + _filter_row(kind, rows[y], prev, bpp).tobytes()
        prev = rows[y]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    path.write_bytes(data)


@pytest.mark.parametrize("ctype", [0, 2, 3, 6])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 1, 0, 3, 2)])
def test_png_reader_matches_pillow(tmp_path, ctype, filters):
    rng = np.random.default_rng(ctype * 10 + len(filters))
    h, w = 7, 11
    bpp = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    pixels = rng.integers(0, 256, (h, w, bpp), dtype=np.uint8)
    pixels[:, :3] = pixels[:, :1] // 2  # runs, so the filters see small residuals too
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (16, 3))
        pixels %= 16
    path = tmp_path / f"t{ctype}.png"
    write_png(path, pixels, ctype, filters, palette)
    ref = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(ttex.read_png(str(path)), ref)
    np.testing.assert_allclose(ttex.load_image(str(path)), jtex.load_image(str(path)), rtol=0, atol=ATOL)


def test_other_formats_need_pillow(tmp_path, monkeypatch):
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    jpg, png16 = tmp_path / "t.jpg", tmp_path / "t16.png"
    Image.fromarray(img).save(jpg)
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(png16)
    for path in (jpg, png16):
        np.testing.assert_allclose(ttex.load_image(str(path)), jtex.load_image(str(path)), rtol=0, atol=ATOL)
    assert ttex.load_image(str(tmp_path / "missing.png")) is None
    assert jtex.load_image(str(tmp_path / "missing.png")) is None
    png8 = tmp_path / "t8.png"
    Image.fromarray(img).save(png8)
    monkeypatch.setitem(sys.modules, "PIL", None)  # Pillow not installed
    assert ttex.load_image(str(jpg)) is None and jtex.load_image(str(jpg)) is None
    np.testing.assert_array_equal(ttex.load_image(str(png8)), img / np.float32(255.0))


def write_textured_obj(directory, n=12, texture=True):
    """A UV-mapped grid (2 n^2 triangles, one quad per row written as a
    polygon) with an MTL whose map_Kd names a PNG."""
    directory.mkdir(parents=True, exist_ok=True)
    lines = ["mtllib model.mtl"]
    for i in range(n + 1):
        for j in range(n + 1):
            lines.append(f"v {i / n:.6f} {j / n:.6f} {0.1 * np.sin(i + j):.6f}")
            lines.append(f"vt {i / n:.6f} {j / n:.6f}")
    for i in range(n):
        for j in range(n):
            a, b, c, d = (i * (n + 1) + j + 1, (i + 1) * (n + 1) + j + 1, (i + 1) * (n + 1) + j + 2,
                          i * (n + 1) + j + 2)
            if j == 0:
                lines.append(f"f {a}/{a} {b}/{b} {c}/{c} {d}/{d}")
            else:
                lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
                lines.append(f"f {a}/{a} {c}/{c} {d}/{d}")
    (directory / "textured.obj").write_text("\n".join(lines) + "\n")
    (directory / "model.mtl").write_text("newmtl m\nKd 1 1 1\nmap_Kd texture_map.png\n")
    if texture:
        img = (ttex.checker(16, 4) * 255).astype(np.uint8)
        img[..., 2] = np.arange(16)[None] * 15
        write_png(directory / "texture_map.png", img, 2, (4, 1, 2, 3, 0))


def test_obj_loading_and_baking(tmp_path):
    write_textured_obj(tmp_path)
    path = str(tmp_path / "textured.obj")
    for t, j in zip(ttex.load_obj_with_uv(path), jtex.load_obj_with_uv(path)):
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    t, j = ttex.bake_obj_face_colors(path), jtex.bake_obj_face_colors(path)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    assert len(np.unique(t[2].round(3), axis=0)) > 4, "the texture reaches the faces"
    (tmp_path / "texture_map.png").unlink()  # a missing texture: the flat fallback
    np.testing.assert_array_equal(ttex.bake_obj_face_colors(path)[2], jtex.bake_obj_face_colors(path)[2])


@pytest.mark.parametrize("max_faces", [800, 100])
def test_ycb_real_visual_branch(tmp_path, monkeypatch, max_faces):
    model = "011_banana"
    write_textured_obj(tmp_path / "assets" / "mani_skill2_ycb" / "models" / model)
    monkeypatch.setattr(jycb, "ASSET_DIR", tmp_path)
    monkeypatch.setattr(tycb, "ASSET_DIR", tmp_path)
    t = tycb.load_model_visual(model, max_faces=max_faces)
    j = jycb.load_model_visual(model, max_faces=max_faces)
    assert len(t[1]) == min(max_faces, 288)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    # other models still build from their stand-ins
    v, f, fc = tycb.load_model_visual("025_mug")
    assert fc is None and len(f) > 0


def test_ycb_collision_ply_raises_as_the_reference(tmp_path, monkeypatch):
    model = "025_mug"
    d = tmp_path / "assets" / "mani_skill2_ycb" / "models" / model
    d.mkdir(parents=True)
    (d / "collision.ply").write_text("ply\nformat ascii 1.0\nend_header\n")
    monkeypatch.setattr(jycb, "ASSET_DIR", tmp_path)
    monkeypatch.setattr(tycb, "ASSET_DIR", tmp_path)
    with pytest.raises(ValueError, match="unsupported mesh format .ply"):
        jycb.load_model_mesh(model)
    with pytest.raises(ValueError, match="unsupported mesh format .ply"):
        tycb.load_model_mesh(model)
    with pytest.raises(ValueError):
        tycb.load_model_visual(model)
