"""Scene files of the 800k-triangle interior for the PyTorch port, and a
textured variant of it.

    python tools/torch_gen_interior.py [DIRECTORY]

``ensure_interior(bench_dir)`` calls the functions of ``tools/gen_interior.py``
with its ``BENCH_DIR`` pointed at ``bench_dir`` and its BMP writer replaced by
the port's numpy one (same 8-bit quantization), so geometry, materials,
lights and camera are that generator's by construction and PIL is not needed.
Its ``.mtl`` names ``map_Kd`` files, which both loaders ignore: the scene
renders without textures.

``ensure_interior_tex(bench_dir)`` writes ``interior_tex.json`` beside it: the
same five meshes, area lights and camera, plus what exercises the texture
path: a ``textures`` block (the three generated BMPs, a generated normal
map, a checkerboard, a 4-octave noise, a mix of two of them, a lat-long EXR
sky), a textured analytic floor slab (``plane`` with ``textureScale``, base
color + roughness textures + normal map with ``normalMapStrength``), the
sphere and box props with textured materials, and the background light with
the sky as ``texture``, so that the loader builds the env distribution and
NEE importance samples it.

``ensure_small_textured(bench_dir)`` is the same layout at a size a CPU
renders in seconds: two meshes of a few hundred triangles.

``ensure_interior_inst(bench_dir)`` writes ``interior_inst.json``: the hall
of ``ensure_interior`` with the same shell meshes, lights, camera, materials
and analytic props, but its 28 columns and 3 torus knots as instances.  One
column at the origin is written once, as ``column.obj``, and placed by 28
translation-only ``mesh`` objects at the baked hall's column positions; one
knot is written once, as ``knot.obj``, and placed 3 times down the aisle.
The loaders turn a mesh path used more than once into one shared geometry
and its instances, so the world geometry is the baked hall's up to float32
rounding.

``ensure_interior_fx(bench_dir)`` writes ``interior_fx.json``: the instanced
hall of ``ensure_interior_inst`` with the ``textures`` block, textured
materials, slab and props of ``ensure_interior_tex``, a camera with
``enableDOF`` focused on the first knot, and an analytic glass sphere whose
material is ``"dispersive": true`` (the Abbe form).  The JSON schema has no
velocities, decals, bokeh shape or shutter-close pose; ``chip_smoke.py``
phase 20 sets those in Python on what the loader returns.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import gen_interior  # noqa: E402  (numpy-only scene generator)

from raytracer_tpu_torch.io.bmp import write_bmp  # noqa: E402
from raytracer_tpu_torch.io.exr import write_exr  # noqa: E402

DEFAULT_DIR = os.path.join(ROOT, "raytracer_tpu_torch", "_build", "interior")


def write_bmp_unit(path, img):
    """8-bit BMP of an image in [0, 1], quantized as ``gen_interior`` does."""
    write_bmp(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def _use(bench_dir: str):
    gen_interior.BENCH_DIR = bench_dir
    gen_interior._write_bmp = write_bmp_unit
    os.makedirs(bench_dir, exist_ok=True)


def ensure_interior(bench_dir: str = DEFAULT_DIR, force: bool = False) -> str:
    """The interior scene of ``gen_interior.ensure_interior`` under
    ``bench_dir`` (idempotent); returns the JSON path."""
    _use(bench_dir)
    return gen_interior.ensure_interior(force)


def normal_map(n: int = 128) -> np.ndarray:
    """Tangent-space normal map of a rippled, grooved surface, encoded
    n * 0.5 + 0.5 in [0, 1]; tiles seamlessly."""
    t = np.arange(n, dtype=np.float64) / n * 2.0 * np.pi
    x, y = np.meshgrid(t, t)
    height = 0.02 * np.sin(4 * x) * np.cos(3 * y) + 0.012 * np.cos(8 * y) + 0.008 * np.sin(2 * x + 5 * y)
    dx = np.gradient(height, axis=1) * n / (2.0 * np.pi)
    dy = np.gradient(height, axis=0) * n / (2.0 * np.pi)
    nrm = np.stack([-dx, -dy, np.ones_like(height)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return nrm * 0.5 + 0.5


def sky_map(h: int = 64, w: int = 128) -> np.ndarray:
    """Lat-long HDR sky (row 0 = straight up): a blue gradient over a dim
    ground, and a small sun 40 degrees above the horizon."""
    theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
    phi = ((np.arange(w, dtype=np.float64) + 0.5) / w - 0.5) * 2.0 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1)
    up = np.clip(d[..., 1], 0.0, 1.0)[..., None]
    sky = (1.0 - up) * np.array([0.9, 0.95, 1.0]) + up * np.array([0.25, 0.45, 0.9])
    img = np.where(d[..., 1:2] >= 0.0, sky, np.array([0.12, 0.11, 0.10]))
    sun = np.array([np.cos(np.deg2rad(40.0)) * 0.6, np.sin(np.deg2rad(40.0)), np.cos(np.deg2rad(40.0)) * 0.8])
    img = img + 80.0 * np.exp(-((1.0 - d @ sun) / 0.004))[..., None] * np.array([1.0, 0.9, 0.75])
    return img.astype(np.float32)


def _texture_files(bench_dir: str) -> dict:
    """The three BMPs of ``gen_interior._textures`` (written anew only if one
    is missing), a normal map and the sky."""
    names = {k: os.path.join(bench_dir, f"tex_{k}.bmp") for k in ("floor", "plaster", "marble")}
    if not all(os.path.exists(p) for p in names.values()):
        gen_interior._textures(np.random.default_rng(gen_interior.SEED))
    names["normal"] = os.path.join(bench_dir, "tex_normal.bmp")
    write_bmp_unit(names["normal"], normal_map())
    names["sky"] = os.path.join(bench_dir, "sky.exr")
    write_exr(names["sky"], sky_map(), half=False)
    return names


def textured_doc(tex: dict, meshes: list, area_lights: list, camera: dict, slab: dict, sphere: dict,
                 box: dict) -> dict:
    """The textured scene in the reference JSON schema."""
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


def ensure_interior_tex(bench_dir: str = DEFAULT_DIR, force: bool = False) -> str:
    """``interior_tex.json``: the interior's meshes, area lights and camera
    with the textured additions (idempotent); returns the JSON path."""
    with open(ensure_interior(bench_dir, force)) as f:
        base = json.load(f)
    json_path = os.path.join(bench_dir, "interior_tex.json")
    if os.path.exists(json_path) and not force:
        return json_path
    by_type = lambda t: next(o for o in base["objects"] if o["type"] == t)
    keep = lambda o: {k: o[k] for k in ("radius", "size", "transform") if k in o}
    doc = textured_doc(
        _texture_files(bench_dir),
        meshes=[o for o in base["objects"] if o["type"] == "mesh"],
        area_lights=[l for l in base["lights"] if l["type"] == "area"],
        camera=base["camera"],
        # above the displaced floor mesh (its bumps stay below 0.07), down the aisle
        slab={"size": [7.0, 30.0], "transform": {"translation": [0.0, 0.09, 0.0], "orientation": [-90.0, 0.0, 0.0]}},
        sphere=keep(by_type("sphere")),
        box=keep(by_type("box")),
    )
    with open(json_path, "w") as f:
        json.dump(doc, f, indent=1)
    return json_path


def ensure_small_textured(bench_dir: str, force: bool = False) -> str:
    """The textured layout over two small meshes (a 450-triangle bumpy patch
    and a 640-triangle torus knot): ``small_tex.json`` (idempotent)."""
    _use(bench_dir)
    json_path = os.path.join(bench_dir, "small_tex.json")
    if os.path.exists(json_path) and not force:
        return json_path
    with open(os.path.join(bench_dir, "interior.mtl"), "w") as f:
        f.write(f"newmtl floor\nKd 0.8 0.8 0.8\nmap_Kd {os.path.join(bench_dir, 'tex_floor.bmp')}\n"
                "newmtl bronze\nKd 0.6 0.4 0.3\n")
    bumps = lambda u, v: 0.08 * np.sin(u * 2.3) * np.cos(v * 1.7)
    pv, pf, puv = gen_interior._grid(16, 16, bumps, 3.0, 3.0)
    gen_interior._write_obj(os.path.join(bench_dir, "patch.obj"), "interior.mtl", [("floor", pv, pf, puv)])
    kv, kf = gen_interior._torus_knot(n_seg=40, n_ring=8, scale=0.3)
    gen_interior._write_obj(os.path.join(bench_dir, "knot.obj"), "interior.mtl",
                            [("bronze", gen_interior._transform(kv, translate=(0.0, 0.3, 1.2)), kf, None)])
    doc = textured_doc(
        _texture_files(bench_dir),
        meshes=[{"type": "mesh", "path": os.path.join(bench_dir, n)} for n in ("patch.obj", "knot.obj")],
        area_lights=[{"type": "area", "color": [9.0, 8.5, 8.0],
                      "transform": {"translation": [0.0, 3.5, 0.0], "orientation": [90.0, 0.0, 0.0]},
                      "shape": {"type": "rect", "size": [0.8, 0.8]}}],
        camera={"transform": {"translation": [0.0, 1.8, -5.0], "orientation": [15.0, 0.0, 0.0]},
                "fieldOfView": 55.0},
        slab={"size": [1.6, 1.2], "transform": {"translation": [0.0, 0.2, -0.8], "orientation": [-90.0, 0.0, 0.0]}},
        sphere={"radius": 0.6, "transform": {"translation": [-1.5, 0.75, 0.3]}},
        box={"size": [0.45, 0.45, 0.45], "transform": {"translation": [1.5, 0.6, 0.2], "orientation": [0, 25, 0]}},
    )
    with open(json_path, "w") as f:
        json.dump(doc, f, indent=1)
    return json_path


def column_positions() -> list:
    """(x, z) of the 28 columns of ``gen_interior.ensure_interior``: two rows
    of 14 down the hall."""
    hx, hz = gen_interior.HX, gen_interior.HZ
    return [(x, -hz + 3.0 + i * (2 * hz - 6.0) / 13.0) for i in range(14) for x in (-hx + 3.0, hx - 3.0)]


KNOT_Z = (-18.0, 0.0, 18.0)


def ensure_interior_inst(bench_dir: str = DEFAULT_DIR, force: bool = False) -> str:
    """``interior_inst.json``: the interior with its columns and knots as 31
    instances of two meshes (idempotent); returns the JSON path."""
    with open(ensure_interior(bench_dir, force)) as f:
        base = json.load(f)
    json_path = os.path.join(bench_dir, "interior_inst.json")
    if os.path.exists(json_path) and not force:
        return json_path
    col_v, col_f = gen_interior._column(np.random.default_rng(gen_interior.SEED))
    column = os.path.join(bench_dir, "column.obj")
    gen_interior._write_obj(column, "interior.mtl", [("marble", col_v, col_f, None)])
    kv, kf = gen_interior._torus_knot()
    knot = os.path.join(bench_dir, "knot.obj")
    gen_interior._write_obj(knot, "interior.mtl", [("bronze", kv, kf, None)])
    baked = {os.path.join(bench_dir, n) for n in ("columns.obj", "knots.obj")}
    place = lambda path, x, z: {"type": "mesh", "path": path, "transform": {"translation": [x, 0.0, z]}}
    shell = [o for o in base["objects"] if o["type"] == "mesh" and o["path"] not in baked]
    doc = dict(base, objects=shell
               + [place(column, x, z) for x, z in column_positions()]
               + [place(knot, 0.0, z) for z in KNOT_Z]
               + [o for o in base["objects"] if o["type"] != "mesh"])
    with open(json_path, "w") as f:
        json.dump(doc, f, indent=1)
    return json_path


FX_SPHERE = {"radius": 0.9, "transform": {"translation": [3.0, 1.0, -30.0]}}  # the dispersive glass sphere


def ensure_interior_fx(bench_dir: str = DEFAULT_DIR, force: bool = False) -> str:
    """``interior_fx.json``: the instanced hall with the textured additions,
    depth of field and a dispersive glass sphere (idempotent); returns the
    JSON path."""
    with open(ensure_interior_inst(bench_dir, force)) as f:
        inst = json.load(f)
    with open(ensure_interior_tex(bench_dir, force)) as f:
        tex = json.load(f)
    json_path = os.path.join(bench_dir, "interior_fx.json")
    if os.path.exists(json_path) and not force:
        return json_path
    meshes = [o for o in inst["objects"] if o["type"] == "mesh"]
    camera = dict(inst["camera"], enableDOF=True, aperture=0.12,
                  focalPlaneDistance=KNOT_Z[0] - inst["camera"]["transform"]["translation"][2])
    doc = dict(tex, objects=meshes + [o for o in tex["objects"] if o["type"] != "mesh"]
               + [{"type": "sphere", "material": "dispersive glass", **FX_SPHERE}],
               materials=tex["materials"] + [{"name": "dispersive glass", "bsdf": "dielectric", "IoR": 1.6,
                                              "dispersive": True, "abbe": 20.0}],
               camera=camera)
    with open(json_path, "w") as f:
        json.dump(doc, f, indent=1)
    return json_path


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR
    for path in (ensure_interior(out), ensure_interior_tex(out), ensure_interior_inst(out), ensure_interior_fx(out)):
        with open(path) as f:
            doc = json.load(f)
        print(f"{path}: {len(doc['objects'])} objects, {len(doc.get('textures', []))} textures, "
              f"{len(doc['lights'])} lights")
