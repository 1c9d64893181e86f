"""The textured hall: the 800k-triangle hall of ``hall.py`` with the texture
layout of ``tools/torch_gen_interior.py::textured_doc``, at the sizes of a
Sponza-class scene.

``write(directory)`` first calls ``hall.py``'s ``write`` (loaded by path),
so the five OBJ files, their ``.mtl`` and the hall's lights and camera are
that generator's byte for byte.  Then it writes, beside them:

- four 1024 x 1024 bitmaps as 24-bit BMP: the floor tiles, plaster and
  column marble of ``tools/gen_interior.py::_textures`` (the same patterns
  over the whole image, drawn from a generator of their own seeded with
  SEED 11, so the hall's geometry draws are untouched) and the rippled
  normal map of ``torch_gen_interior.normal_map``, sRGB-encoded, since
  both loaders decode every bitmap from sRGB;
- a 1024 x 512 lat-long sky with the pattern of
  ``torch_gen_interior.sky_map``, clipped to [0, 1] and written as a 24-bit
  BMP (an LDR sky: the reference reads no EXR), rows flipped so that the
  loaders' BMP convention puts its zenith straight up;
- ``interior_tex.json``: the hall's meshes and area lights, a ``textures``
  block (bitmap, checkerboard, 4-octave noise, and a mix of two of them by
  the third), a textured, normal-mapped analytic floor slab with
  ``textureScale``, a textured chrome sphere and box, and a background
  light whose texture is the sky, so the loader builds the env
  distribution and NEE importance-samples it.

The hall is opened to the sky as Sponza's court is: the scene places the
ceiling mesh (its file unchanged) half the hall's width toward -x
(``ROOF_SHIFT``), so the roof covers the half at x < 0, overhanging that
wall, and the half at x > 0 is open.  The sky and its sun light the floor,
the slab and the columns through the opening, and camera rays that leave
through it read the sky.

The meshes stay untextured: both loaders read only ``Kd``, ``Ke`` and
``ior`` of an OBJ material.  ``write_small(directory)`` writes the same
textures and materials over two small meshes, in an open layout the sky
lights, at a size a CPU renders in seconds.  numpy only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import struct

import numpy as np

SEED = 11
TEX = 1024  # side of the bitmaps: Crytek Sponza's textures are mostly 1024^2
SKY_W, SKY_H = 1024, 512
ROOF_SHIFT = [-16.0, 0.0, 0.0]  # the ceiling mesh's translation: hall.py's HX


def _hall():
    """``hall.py`` beside this file, as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hall.py")
    spec = importlib.util.spec_from_file_location("bench_generators_hall_for_tex", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_bmp(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) image in [0, 1] as a bottom-up 24-bit BMP, quantized as
    ``tools/gen_interior.py`` does (clip, times 255, truncated)."""
    px = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = px.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = px[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up, BGR
    header = struct.pack("<2sIHHI", b"BM", 54 + stride * h, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + rows.tobytes())


def srgb_encode(c: np.ndarray) -> np.ndarray:
    """The exact sRGB OETF, the inverse of the loaders' decode."""
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.power(np.maximum(c, 1e-7), 1.0 / 2.4) - 0.055)


def bitmaps(n: int = TEX) -> dict:
    """The floor tiles, plaster and marble of ``gen_interior._textures``,
    drawn at n x n with the pattern scaled from its 256^2 (8 x 8 tiles,
    16 x 16 plaster blotches, the same veins), per-texel noise at n."""
    rng = np.random.default_rng(SEED)
    s = n // 256
    yy, xx = np.mgrid[0:n, 0:n]
    tile = ((xx // (32 * s) + yy // (32 * s)) % 2).astype(np.float32)
    marb = 0.55 + 0.25 * tile[..., None] + 0.08 * rng.standard_normal((n, n, 1))
    floor = np.repeat(marb, 3, axis=2) * np.array([1.0, 0.97, 0.9])
    blotch = np.kron(rng.standard_normal((16, 16, 1)), np.ones((n // 16, n // 16, 1)))
    plaster = np.repeat(0.75 + 0.06 * blotch + 0.03 * rng.standard_normal((n, n, 1)), 3, axis=2) * np.array(
        [1.0, 0.95, 0.88])
    v = np.sin(xx / s * 0.21 + 3.0 * np.sin(yy / s * 0.02)) * 0.5 + 0.5
    marble = (0.6 + 0.25 * v)[..., None] * np.array([0.95, 0.93, 0.9]) + 0.04 * rng.standard_normal((n, n, 3))
    return {"floor": floor, "plaster": plaster, "marble": marble}


def normal_map(n: int = TEX) -> np.ndarray:
    """Tangent-space normal map of a rippled, grooved surface, encoded
    n * 0.5 + 0.5 in [0, 1]; tiles seamlessly (``torch_gen_interior``'s)."""
    t = np.arange(n, dtype=np.float64) / n * 2.0 * np.pi
    x, y = np.meshgrid(t, t)
    height = 0.02 * np.sin(4 * x) * np.cos(3 * y) + 0.012 * np.cos(8 * y) + 0.008 * np.sin(2 * x + 5 * y)
    dx = np.gradient(height, axis=1) * n / (2.0 * np.pi)
    dy = np.gradient(height, axis=0) * n / (2.0 * np.pi)
    nrm = np.stack([-dx, -dy, np.ones_like(height)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return nrm * 0.5 + 0.5


def sky_map(h: int = SKY_H, w: int = SKY_W) -> np.ndarray:
    """Lat-long sky (row 0 = straight up): a blue gradient over a dim
    ground and a small sun 40 degrees above the horizon
    (``torch_gen_interior``'s), clipped to [0, 1]."""
    theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
    phi = ((np.arange(w, dtype=np.float64) + 0.5) / w - 0.5) * 2.0 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1)
    up = np.clip(d[..., 1], 0.0, 1.0)[..., None]
    sky = (1.0 - up) * np.array([0.9, 0.95, 1.0]) + up * np.array([0.25, 0.45, 0.9])
    img = np.where(d[..., 1:2] >= 0.0, sky, np.array([0.12, 0.11, 0.10]))
    sun = np.array([np.cos(np.deg2rad(40.0)) * 0.6, np.sin(np.deg2rad(40.0)), np.cos(np.deg2rad(40.0)) * 0.8])
    img = img + 80.0 * np.exp(-((1.0 - d @ sun) / 0.004))[..., None] * np.array([1.0, 0.9, 0.75])
    return np.clip(img, 0.0, 1.0)


def _write_textures(directory: str) -> dict:
    """The six image files; returns their names relative to ``directory``."""
    images = {f"tex_{k}.bmp": v for k, v in bitmaps().items()}
    # both loaders decode every bitmap from sRGB, a normal map too: store it
    # sRGB-encoded so that the decoded texels are the normals (stored as
    # they are, a flat 0.5 decodes to 0.21 and tilts every normal by ~39
    # degrees, which turns most of the slab away from the camera)
    images["tex_normal.bmp"] = srgb_encode(normal_map())
    # both loaders take a BMP's stored rows, bottom-up, as v from 0 (the
    # reference renderer's convention), and the lat-long lookup puts v = 0
    # straight up: so the sky is stored upside down as a viewer shows it
    images["sky.bmp"] = sky_map()[::-1]
    for name, img in images.items():
        write_bmp(os.path.join(directory, name), img)
    return {"floor": "tex_floor.bmp", "plaster": "tex_plaster.bmp", "marble": "tex_marble.bmp",
            "normal": "tex_normal.bmp", "sky": "sky.bmp"}


def textured_doc(tex: dict, meshes: list, area_lights: list, camera: dict, slab: dict, sphere: dict,
                 box: dict) -> dict:
    """The textured scene in the reference JSON schema
    (``torch_gen_interior.textured_doc``'s)."""
    return {
        "textures": [
            # a mix may name textures declared after it
            {"name": "veined", "type": "mix", "textureA": "marble", "textureB": "check", "weight": "cloud"},
            {"name": "tiles", "type": "bitmap", "path": tex["floor"]},
            {"name": "plaster", "type": "bitmap", "path": tex["plaster"]},
            {"name": "marble", "type": "bitmap", "path": tex["marble"]},
            {"name": "ripples", "type": "bitmap", "path": tex["normal"]},
            {"name": "check", "type": "checkerboard", "colorA": [0.9, 0.85, 0.8], "colorB": [0.25, 0.22, 0.2]},
            {"name": "cloud", "type": "noise", "colorA": [1.0, 1.0, 1.0], "colorB": [0.15, 0.15, 0.15],
             "octaves": 4},
            {"name": "sky", "type": "bitmap", "path": tex["sky"]},
        ],
        "materials": [
            {"name": "chrome", "bsdf": "roughMetal", "baseColor": [0.95, 0.96, 0.97], "roughness": 0.3,
             "baseColorTexture": "plaster", "roughnessTexture": "cloud", "metalnessTexture": "check",
             "metalness": 1.0},
            {"name": "crate", "bsdf": "roughDiffuse", "baseColor": [1.0, 1.0, 1.0], "roughness": 0.6,
             "baseColorTexture": "veined"},
            {"name": "slab", "bsdf": "roughPlastic", "baseColor": [0.9, 0.9, 0.9], "roughness": 0.5,
             "baseColorTexture": "tiles", "roughnessTexture": "cloud", "normalMap": "ripples",
             "normalMapStrength": 0.7},
        ],
        "objects": meshes + [
            {"type": "sphere", "material": "chrome", **sphere},
            {"type": "box", "material": "crate", **box},
            {"type": "plane", "material": "slab", "textureScale": [0.25, 0.25], **slab},
        ],
        "lights": area_lights + [{"type": "background", "color": [0.5, 0.5, 0.5], "texture": "sky"}],
        "camera": camera,
    }


def _dump(path: str, doc: dict) -> str:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def write(directory: str) -> str:
    """Write the hall's files and the textured additions into
    ``directory``; returns the path of ``interior_tex.json``."""
    with open(_hall().write(directory)) as f:
        base = json.load(f)
    by_type = lambda t: next(o for o in base["objects"] if o["type"] == t)
    keep = lambda o: {k: o[k] for k in ("radius", "size", "transform") if k in o}
    meshes = [o for o in base["objects"] if o["type"] == "mesh"]
    roof = next(o for o in meshes if o["path"] == "shell_ceiling.obj")
    roof["transform"] = {"translation": ROOF_SHIFT}
    doc = textured_doc(
        _write_textures(directory),
        meshes=meshes,
        area_lights=[l for l in base["lights"] if l["type"] == "area"],
        camera=base["camera"],
        # above the displaced floor mesh (its bumps stay below 0.07), down the aisle
        slab={"size": [7.0, 30.0], "transform": {"translation": [0.0, 0.09, 0.0], "orientation": [-90.0, 0.0, 0.0]}},
        sphere=keep(by_type("sphere")),
        box=keep(by_type("box")),
    )
    return _dump(os.path.join(directory, "interior_tex.json"), doc)


def write_small(directory: str) -> str:
    """The same textures and materials over two small meshes (a
    450-triangle bumpy patch and a 640-triangle torus knot) under one area
    light, open to the sky (``torch_gen_interior.ensure_small_textured``'s
    layout); returns the path of ``small_tex.json``."""
    hall = _hall()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "interior.mtl"), "w") as f:
        f.write("newmtl floor\nKd 0.8 0.8 0.8\nnewmtl bronze\nKd 0.6 0.4 0.3\n")
    pv, pf, puv = hall._grid(16, 16, lambda u, v: 0.08 * np.sin(u * 2.3) * np.cos(v * 1.7), 3.0, 3.0)
    hall._write_obj(os.path.join(directory, "patch.obj"), [("floor", pv, pf, puv)])
    kv, kf = hall._torus_knot(n_seg=40, n_ring=8, scale=0.3)
    hall._write_obj(os.path.join(directory, "knot.obj"), [("bronze", hall._translate(kv, (0.0, 0.3, 1.2)), kf, None)])
    doc = textured_doc(
        _write_textures(directory),
        meshes=[{"type": "mesh", "path": n} for n in ("patch.obj", "knot.obj")],
        area_lights=[{"type": "area", "color": [9.0, 8.5, 8.0],
                      "transform": {"translation": [0.0, 3.5, 0.0], "orientation": [90.0, 0.0, 0.0]},
                      "shape": {"type": "rect", "size": [0.8, 0.8]}}],
        camera={"transform": {"translation": [0.0, 1.8, -5.0], "orientation": [15.0, 0.0, 0.0]},
                "fieldOfView": 55.0},
        slab={"size": [1.6, 1.2], "transform": {"translation": [0.0, 0.2, -0.8], "orientation": [-90.0, 0.0, 0.0]}},
        sphere={"radius": 0.6, "transform": {"translation": [-1.5, 0.75, 0.3]}},
        box={"size": [0.45, 0.45, 0.45], "transform": {"translation": [1.5, 0.6, 0.2], "orientation": [0, 25, 0]}},
    )
    return _dump(os.path.join(directory, "small_tex.json"), doc)
