"""The instanced hall: the 800k-triangle hall of ``hall.py`` with its 28
columns and 3 torus knots placed as 31 instances of 2 shared meshes.

The shell (floor, ceiling, walls), the lights, the sphere, the box and the
camera are ``hall.write``'s, draw for draw.  The column and the knot are
written once each, in object space, by ``hall.py``'s mesh functions, and the scene
file places them at the positions where ``hall.write`` bakes them: a scene
file that places one OBJ several times at scale 1 loads as one shared mesh
and one rigid instance a placement.  The world holds the baked hall's
799,964 triangles.

``write(directory)`` writes the files and returns the scene file's path;
``write_small(directory)`` writes a layout of the same kind small enough
for a CPU run at 16^2: a shell of two grids, and thin poles, coarse columns
and knots as 18 instances of 3 meshes, under one rect light.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np


def _hall():
    """``hall.py``, beside this file (the harness loads generators by path)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hall.py")
    spec = importlib.util.spec_from_file_location("bench_generators_hall_for_inst", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def column_positions(hall) -> list:
    """(x, z) of the 28 columns, in the order ``hall.write`` bakes them."""
    out = []
    for i in range(14):
        z = -hall.HZ + 3.0 + i * (2 * hall.HZ - 6.0) / 13.0
        out += [(x, z) for x in (-hall.HX + 3.0, hall.HX - 3.0)]
    return out


KNOT_Z = (-18.0, 0.0, 18.0)
BAKED = ("columns.obj", "knots.obj")  # what the shared meshes replace


def _place(path: str, x: float, z: float) -> dict:
    return {"type": "mesh", "path": path, "transform": {"translation": [x, 0.0, z]}}


def write(directory: str) -> str:
    """Write the instanced hall's files into ``directory``; returns the JSON
    path."""
    hall = _hall()
    baked = hall.write(directory)
    with open(baked) as f:
        base = json.load(f)
    for path in [baked] + [os.path.join(directory, name) for name in BAKED]:
        os.remove(path)
    col_v, col_f = hall._column()
    hall._write_obj(os.path.join(directory, "column.obj"), [("marble", col_v, col_f, None)])
    kv, kf = hall._torus_knot()
    hall._write_obj(os.path.join(directory, "knot.obj"), [("bronze", kv, kf, None)])
    meshes = [o for o in base["objects"] if o["type"] == "mesh" and o["path"] not in BAKED]
    doc = dict(base, objects=meshes
               + [_place("column.obj", x, z) for x, z in column_positions(hall)]
               + [_place("knot.obj", 0.0, z) for z in KNOT_Z]
               + [o for o in base["objects"] if o["type"] != "mesh"])
    path = os.path.join(directory, "interior_inst.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def write_small(directory: str) -> str:
    """A small instanced layout for CPU runs: a floor and a back wall as
    grids; a row of 12 thin poles across the view, 4 coarse columns and 2
    coarse knots (the last instance, turned, in the middle of the view), as
    18 instances of 3 meshes; a chrome sphere, a rect light and a
    background light.  Every mesh is diffuse, so that where an instance
    stands shows in the image.  Returns the JSON path."""
    hall = _hall()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "interior.mtl"), "w") as f:
        f.write("newmtl floor\nKd 0.8 0.8 0.8\nnewmtl plaster\nKd 0.85 0.82 0.78\n"
                "newmtl marble\nKd 0.9 0.9 0.9\nnewmtl bronze\nKd 0.6 0.42 0.25\n")
    rng = np.random.default_rng(hall.SEED)
    bumpy = lambda U, V: 0.05 * np.sin(U * 2.3) * np.cos(V * 1.7) + 0.01 * rng.standard_normal(U.shape)
    fv, ff, fuv = hall._grid(12, 12, bumpy, 6.0, 8.0)
    wv, wf, wuv = hall._grid(12, 6, bumpy, 6.0, 3.5)
    wall = np.stack([wv[:, 0], wv[:, 2] + 3.5, 8.0 - wv[:, 1]], -1).astype(np.float32)
    hall._write_obj(os.path.join(directory, "shell.obj"),
                    [("floor", fv, ff, fuv), ("plaster", wall, wf[:, ::-1], wuv)])
    # the hall's mesh functions wind their faces inward; turned here so that the
    # loaders' normals face out and both meshes shade from outside
    col_v, col_f = _coarse_column(hall)
    hall._write_obj(os.path.join(directory, "column.obj"), [("marble", col_v, col_f[:, ::-1], None)])
    kv, kf = hall._torus_knot(n_seg=48, n_ring=8, scale=0.7)
    hall._write_obj(os.path.join(directory, "knot.obj"), [("bronze", kv, kf[:, ::-1], None)])
    pv, pf = _pole()
    hall._write_obj(os.path.join(directory, "pole.obj"), [("plaster", pv, pf, None)])
    turned = {"type": "mesh", "path": "knot.obj",
              "transform": {"translation": [0.6, -0.5, -1.5], "orientation": [0.0, 35.0, 0.0]}}
    doc = {
        "materials": [{"name": "chrome", "bsdf": "metal", "color": [0.95, 0.96, 0.97], "roughness": 0.08}],
        "objects": [{"type": "mesh", "path": "shell.obj"}]
        + [_place("pole.obj", -3.3 + 0.6 * k, 0.5) for k in range(12)]
        + [_place("column.obj", x, z) for x in (-1.8, 2.0) for z in (-2.5, 3.0)]
        + [_place("knot.obj", -2.0, 5.0), turned]
        + [{"type": "sphere", "radius": 0.6, "material": "chrome", "transform": {"translation": [-1.2, 0.6, 2.5]}}],
        "lights": [
            {"type": "area", "color": [14.0, 13.0, 11.5],
             "transform": {"translation": [0.0, 5.5, 2.0], "orientation": [180.0, 0.0, 0.0]},
             "shape": {"type": "rect", "size": [2.5, 2.5]}},
            {"type": "background", "color": [0.12, 0.14, 0.18]},
        ],
        "camera": {"transform": {"translation": [0.0, 2.2, -6.0], "orientation": [8.0, 0.0, 0.0]},
                   "fieldOfView": 70.0},
    }
    path = os.path.join(directory, "interior_inst.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def _coarse_column(hall):
    """``hall._column``'s shape at 12 rings of 16 facets, the ring on top
    left out: a fluted shaft of 352 triangles."""
    n_seg, n_ring = 12, 16
    ys = np.linspace(0.0, hall.HY - 1.2, n_seg, dtype=np.float32) * np.float32(0.6)
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False, dtype=np.float32)
    TH, Y = np.meshgrid(th, ys)
    R = 0.45 * (1.0 + 0.05 * np.cos(4 * TH))
    verts = np.stack([R * np.cos(TH), Y, R * np.sin(TH)], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n_seg * n_ring).reshape(n_seg, n_ring)
    a, b = idx[:-1, :], np.roll(idx[:-1, :], -1, axis=1)
    c, d = idx[1:, :], np.roll(idx[1:, :], -1, axis=1)
    faces = np.concatenate([np.stack([a.ravel(), b.ravel(), d.ravel()], 1),
                            np.stack([a.ravel(), d.ravel(), c.ravel()], 1)], axis=0)
    return verts, faces


def _pole(radius=0.06, height=3.0, facets=8):
    """A thin upright prism standing on the origin: 2 * facets triangles
    wound outward (no caps)."""
    th = np.arange(facets) * (2 * np.pi / facets)
    ring = np.stack([radius * np.cos(th), np.zeros(facets), radius * np.sin(th)], -1)
    v = np.concatenate([ring, ring + [0.0, height, 0.0]]).astype(np.float32)
    a = np.arange(facets)
    b = (a + 1) % facets
    return v, np.concatenate([np.stack([a, b + facets, b], 1), np.stack([a, a + facets, b + facets], 1)])
