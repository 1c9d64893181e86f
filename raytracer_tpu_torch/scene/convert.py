"""Carry a scene from the JAX package into the port, field by field.

``scene_from_numpy`` takes the reference's ``SceneData`` / ``ClusterSet``
/ ``Camera`` / ``SceneMeta`` (or any NamedTuple of them) whose array leaves
were mapped to numpy, and builds the port's type of the same name, field by
field (the texture atlas, the environment map's distribution, the skip-link
BVH, shared meshes and instances, decals, velocities, the dispersion
columns and the camera's shutter-close pose and bokeh included).  A
reference object with a field its port type does not hold raises instead
of losing it.  This lets a test run one module of each package on
bit-identical data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math.distribution import Distribution, Distribution2D
from ..math.vec import Vec3
from ..ops.textures import atlas_static
from . import types as T
from .clusters import ClusterSet

_PORT_TYPES = {
    cls.__name__: cls
    for cls in (T.SceneData, T.Primitives, T.Triangles, T.Materials, T.Lights,
                T.Rot3, T.Camera, T.SceneMeta, T.TextureAtlas, T.BVHFlat, T.MeshGeom, T.Instances, T.Decals,
                Distribution, Distribution2D, Vec3, ClusterSet)
}


def _field_names(cls) -> tuple:
    if dataclasses.is_dataclass(cls):
        return tuple(f.name for f in dataclasses.fields(cls))
    return cls._fields


def scene_from_numpy(obj, device):
    """Port-side copy of a reference object whose arrays are numpy."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        # plain tuples: static metadata, or arrays (ClusterSet.tree_levels)
        return tuple(scene_from_numpy(x, device) for x in obj)
    if isinstance(obj, (np.ndarray, np.generic)):
        return torch.as_tensor(np.array(obj)).to(device)
    cls = _PORT_TYPES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port type for {type(obj).__name__}")
    lost = [f for f in _field_names(type(obj)) if f not in _field_names(cls)]
    if lost:
        raise TypeError(f"the port's {cls.__name__} has no field {lost}: converting would drop it")
    if cls is T.SceneMeta:
        return T.SceneMeta(**{f: getattr(obj, f) for f in _field_names(cls)})
    if cls is T.TextureAtlas:
        # the reference's table has the arrays only; its static facts are read off them
        arrays = {f: scene_from_numpy(getattr(obj, f), device) for f in type(obj)._fields}
        return T.TextureAtlas(**arrays, **atlas_static(np.asarray(obj.kind), np.asarray(obj.octaves)))
    return cls(**{f: scene_from_numpy(getattr(obj, f), device) for f in _field_names(cls)})
