"""The 800k-triangle hall, frozen from ``tools/gen_interior.py`` (SEED 11).

A colonnaded hall: floor, ceiling and walls as displaced grids, two rows
of 14 fluted columns, three torus knots, a chrome sphere and a glass box,
two rect area lights and a background light, in the reference renderer's
JSON schema.  The geometry, materials, lights and camera are that
generator's, draw for draw of its random generator.  Left out: the three
BMP textures its ``.mtl`` names with ``map_Kd``, which the scene loader
ignores (their random draws are still made, so the geometry that follows
is the same), and absolute paths (the JSON names its OBJ files relative to
itself).

``write(directory)`` writes the files; 799,964 triangles in all.
"""

from __future__ import annotations

import json
import os

import numpy as np

SEED = 11
HX, HY, HZ = 16.0, 7.0, 40.0  # half-width, height, half-depth


def _texture_draws(rng):
    """The draws of the generator's three textures, in order."""
    rng.standard_normal((256, 256, 1))
    rng.standard_normal((16, 16, 1))
    rng.standard_normal((256, 256, 1))
    rng.standard_normal((256, 256, 3))


def _grid(nx, nz, fx, half_u, half_v):
    us = np.linspace(-half_u, half_u, nx, dtype=np.float32)
    vs = np.linspace(-half_v, half_v, nz, dtype=np.float32)
    U, V = np.meshgrid(us, vs)
    H = fx(U, V).astype(np.float32)
    verts = np.stack([U, H, V], axis=-1).reshape(-1, 3)
    idx = np.arange(nx * nz).reshape(nz, nx)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, d, b], axis=1), np.stack([a, c, d], axis=1)], axis=0)
    uv = np.stack([(U + half_u) / (2 * half_u), (V + half_v) / (2 * half_v)], -1).reshape(-1, 2)
    return verts, faces, uv


def _translate(verts, translate):
    return verts * 1.0 + np.asarray(translate, np.float32)


def _column(n_seg=96, n_ring=64):
    ys = np.linspace(0.0, HY - 1.2, n_seg, dtype=np.float32)
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False, dtype=np.float32)
    TH, Y = np.meshgrid(th, ys)
    R = 0.55 * (1.0 + 0.05 * np.cos(12 * TH)) * (1.0 + 0.08 * (1 - Y / HY))
    verts = np.stack([R * np.cos(TH), Y, R * np.sin(TH)], axis=-1).reshape(-1, 3)
    idx = np.arange(n_seg * n_ring).reshape(n_seg, n_ring)
    a, b = idx[:-1, :], np.roll(idx[:-1, :], -1, axis=1)
    c, d = idx[1:, :], np.roll(idx[1:, :], -1, axis=1)
    faces = np.concatenate([np.stack([a.ravel(), b.ravel(), d.ravel()], 1),
                            np.stack([a.ravel(), d.ravel(), c.ravel()], 1)], axis=0)
    tn, tm = 24, 48
    u = np.linspace(0, 2 * np.pi, tm, endpoint=False, dtype=np.float32)
    v = np.linspace(0, 2 * np.pi, tn, endpoint=False, dtype=np.float32)
    UU, VV = np.meshgrid(u, v)
    tr, sr = 0.62, 0.22
    tverts = np.stack([(tr + sr * np.cos(VV)) * np.cos(UU), 0.5 * sr * np.sin(VV) + (HY - 1.1),
                       (tr + sr * np.cos(VV)) * np.sin(UU)], -1).reshape(-1, 3)
    tidx = np.arange(tn * tm).reshape(tn, tm) + len(verts)
    ta, tb = tidx, np.roll(tidx, -1, 1)
    tc, td = np.roll(tidx, -1, 0), np.roll(np.roll(tidx, -1, 0), -1, 1)
    tfaces = np.concatenate([np.stack([ta.ravel(), tb.ravel(), td.ravel()], 1),
                             np.stack([ta.ravel(), td.ravel(), tc.ravel()], 1)], axis=0)
    return np.concatenate([verts, tverts]), np.concatenate([faces, tfaces])


def _torus_knot(p=2, q=3, n_seg=400, n_ring=40, scale=0.9):
    t = np.linspace(0, 2 * np.pi, n_seg, endpoint=False, dtype=np.float32)
    r = 2.0 + np.cos(q * t)
    center = np.stack([r * np.cos(p * t), np.sin(q * t) + 2.2, r * np.sin(p * t)], -1) * scale
    d = np.roll(center, -1, 0) - center
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = np.cross(d, np.array([0, 1, 0], np.float32))
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    m = np.cross(s, d)
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False, dtype=np.float32)
    tube = 0.22 * scale
    verts = (center[:, None, :] + tube * (np.cos(th)[None, :, None] * s[:, None, :]
                                          + np.sin(th)[None, :, None] * m[:, None, :])).reshape(-1, 3)
    idx = np.arange(n_seg * n_ring).reshape(n_seg, n_ring)
    a, b = idx, np.roll(idx, -1, 1)
    c, d2 = np.roll(idx, -1, 0), np.roll(np.roll(idx, -1, 0), -1, 1)
    faces = np.concatenate([np.stack([a.ravel(), b.ravel(), d2.ravel()], 1),
                            np.stack([a.ravel(), d2.ravel(), c.ravel()], 1)], axis=0)
    return verts, faces


def _write_obj(path, parts):
    """parts: (material, verts, faces, uvs or None), written as the
    generator writes them (5 decimals, 1-based indices)."""
    lines = ["mtllib interior.mtl\n"]
    v_off = vt_off = 1
    chunks = []
    for mat, verts, faces, uvs in parts:
        lines += [f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n" for v in verts]
        if uvs is not None:
            lines += [f"vt {t[0]:.5f} {t[1]:.5f}\n" for t in uvs]
        chunks.append((mat, faces, v_off, vt_off if uvs is not None else None))
        v_off += len(verts)
        if uvs is not None:
            vt_off += len(uvs)
    for mat, faces, vo, vto in chunks:
        lines.append(f"usemtl {mat}\n")
        if vto is not None:
            lines += [f"f {a+vo}/{a+vto} {b+vo}/{b+vto} {c+vo}/{c+vto}\n" for a, b, c in faces.tolist()]
        else:
            lines += [f"f {a+vo} {b+vo} {c+vo}\n" for a, b, c in faces.tolist()]
    with open(path, "w") as f:
        f.writelines(lines)


def write(directory: str) -> str:
    """Write the hall's files into ``directory``; returns the JSON path."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(SEED)
    _texture_draws(rng)
    with open(os.path.join(directory, "interior.mtl"), "w") as f:
        f.write("newmtl floor\nKd 0.8 0.8 0.8\nnewmtl plaster\nKd 0.85 0.82 0.78\n"
                "newmtl marble\nKd 0.9 0.9 0.9\nnewmtl ceiling\nKd 0.7 0.72 0.75\n"
                "newmtl bronze\nKd 0.05 0.04 0.03\nKs 0.95 0.64 0.54\nNs 600\n"
                "newmtl wood\nKd 0.45 0.29 0.17\n")
    rough = lambda U, V: 0.03 * np.sin(U * 2.3) * np.cos(V * 1.7) + 0.008 * rng.standard_normal(U.shape)
    fv, ff, fuv = _grid(230, 230, rough, HX, HZ)
    cv, cf, cuv = _grid(230, 230, lambda U, V: HY - rough(U, V), HX, HZ)
    cf = cf[:, ::-1]
    out = lambda name: os.path.join(directory, name)
    _write_obj(out("shell_floor.obj"), [("floor", fv, ff, fuv)])
    _write_obj(out("shell_ceiling.obj"), [("ceiling", cv, cf, cuv)])
    walls = []
    wv, wf, wuv = _grid(260, 60, rough, HZ, HY / 2)
    for side, x0 in enumerate((-HX, HX)):
        inward = -np.sign(x0)
        v = np.stack([x0 + inward * wv[:, 1], wv[:, 2] + HY / 2, wv[:, 0]], -1).astype(np.float32)
        walls.append(("plaster", v, wf if side == 0 else wf[:, ::-1], wuv))
    sv, sf, suv = _grid(120, 60, rough, HX, HY / 2)
    for side, z0 in enumerate((-HZ, HZ)):
        inward = -np.sign(z0)
        v = np.stack([sv[:, 0], sv[:, 2] + HY / 2, z0 + inward * sv[:, 1]], -1).astype(np.float32)
        walls.append(("plaster", v, sf if side == 1 else sf[:, ::-1], suv))
    _write_obj(out("shell_walls.obj"), walls)
    col_v, col_f = _column()
    parts = []
    for i in range(14):
        z = -HZ + 3.0 + i * (2 * HZ - 6.0) / 13.0
        for x in (-HX + 3.0, HX - 3.0):
            parts.append(("marble", _translate(col_v, (x, 0.0, z)), col_f, None))
    _write_obj(out("columns.obj"), parts)
    kv, kf = _torus_knot()
    _write_obj(out("knots.obj"), [("bronze", _translate(kv, (0.0, 0.0, z)), kf, None) for z in (-18.0, 0.0, 18.0)])
    scene = {
        "materials": [
            {"name": "chrome", "bsdf": "metal", "color": [0.95, 0.96, 0.97], "roughness": 0.08},
            {"name": "glass", "bsdf": "dielectric", "color": [1.0, 1.0, 1.0], "IoR": 1.5},
        ],
        "objects": [{"type": "mesh", "path": name} for name in
                    ("shell_floor.obj", "shell_ceiling.obj", "shell_walls.obj", "columns.obj", "knots.obj")] + [
            {"type": "sphere", "radius": 1.1, "material": "chrome", "transform": {"translation": [-6.0, 1.1, -9.0]}},
            {"type": "box", "size": [0.9, 0.9, 0.9], "material": "glass",
             "transform": {"translation": [6.0, 0.95, 9.0]}},
        ],
        "lights": [
            {"type": "area", "color": [14.0, 13.0, 11.5],
             "transform": {"translation": [0.0, HY - 0.12, -12.0], "orientation": [180.0, 0.0, 0.0]},
             "shape": {"type": "rect", "size": [3.2, 3.2]}},
            {"type": "area", "color": [14.0, 13.0, 11.5],
             "transform": {"translation": [0.0, HY - 0.12, 12.0], "orientation": [180.0, 0.0, 0.0]},
             "shape": {"type": "rect", "size": [3.2, 3.2]}},
            {"type": "background", "color": [0.12, 0.14, 0.18]},
        ],
        "camera": {"transform": {"translation": [0.0, 2.6, -HZ + 2.5], "orientation": [6.0, 0.0, 0.0]},
                   "fieldOfView": 70.0},
    }
    path = out("interior.json")
    with open(path, "w") as f:
        json.dump(scene, f, indent=1)
    return path
