"""Device-side scene representation: structure-of-arrays NamedTuples of
tensors (port of ``raytracer_tpu/scene/types.py``).

Field names follow the reference so ``scene/convert.py`` can carry a JAX
scene across by name: every field of a reference type has a field of the
same name here (``tests/test_torch_scene.py`` holds that).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..math.vec import Vec3

# --- enums ----------------------------------------------------------------------
PRIM_SPHERE = 0
PRIM_BOX = 1
PRIM_RECT = 2

BSDF_NULL = 0
BSDF_DIFFUSE = 1
BSDF_ROUGH_DIFFUSE = 2
BSDF_DIELECTRIC = 3
BSDF_ROUGH_DIELECTRIC = 4
BSDF_METAL = 5
BSDF_ROUGH_METAL = 6
BSDF_PLASTIC = 7
BSDF_ROUGH_PLASTIC = 8

BSDF_NAMES = {
    "null": BSDF_NULL,
    "diffuse": BSDF_DIFFUSE,
    "roughDiffuse": BSDF_ROUGH_DIFFUSE,
    "dielectric": BSDF_DIELECTRIC,
    "roughDielectric": BSDF_ROUGH_DIELECTRIC,
    "metal": BSDF_METAL,
    "roughMetal": BSDF_ROUGH_METAL,
    "plastic": BSDF_PLASTIC,
    "roughPlastic": BSDF_ROUGH_PLASTIC,
}

LIGHT_AREA = 0
LIGHT_BACKGROUND = 1
LIGHT_POINT = 2
LIGHT_SPOT = 3
LIGHT_DIRECTIONAL = 4

SHAPE_RECT = 0
SHAPE_SPHERE = 1
SHAPE_BOX = 2

# roughness below this threshold => the rough BSDF acts as its specular twin
SPECULAR_ROUGHNESS_THRESHOLD = 0.005

INVALID_ID = -1


class Rot3(NamedTuple):
    """Rotation as three world-space basis rows (row-vector convention)."""

    r0: Vec3
    r1: Vec3
    r2: Vec3

    def to_world(self, v: Vec3) -> Vec3:
        return self.r0 * v.x + self.r1 * v.y + self.r2 * v.z

    def to_local(self, v: Vec3) -> Vec3:
        from ..math.vec import dot

        return Vec3(dot(v, self.r0), dot(v, self.r1), dot(v, self.r2))


class Primitives(NamedTuple):
    """Analytic traceable objects, SoA over P prims."""

    kind: torch.Tensor  # (P,) int32: PRIM_*
    rot: Rot3
    trans: Vec3
    param: Vec3  # sphere: (radius,-,-); box/rect: half-size
    material_id: torch.Tensor  # (P,) int32
    light_id: torch.Tensor  # (P,) int32, INVALID_ID unless this prim IS a light
    # linear velocity over the shutter interval: at ray time t the prim's
    # translation is trans + vel * t (motion blur)
    vel: Vec3
    uv_scale: Vec3  # per-object texture-coordinate scale (u, v, 1)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Triangles(NamedTuple):
    """World-space triangle soup in BVH leaf order, SoA over T tris."""

    v0: Vec3
    e1: Vec3
    e2: Vec3
    n0: Vec3
    n1: Vec3
    n2: Vec3
    uv0_u: torch.Tensor
    uv0_v: torch.Tensor
    uv1_u: torch.Tensor
    uv1_v: torch.Tensor
    uv2_u: torch.Tensor
    uv2_v: torch.Tensor
    material_id: torch.Tensor  # (T,) int32

    @property
    def count(self) -> int:
        return self.material_id.shape[0]


class BVHFlat(NamedTuple):
    """Flattened binary BVH, pre-threaded per ray-direction octant with
    skip links: ``hit`` (next node when the ray hits the node's box: the
    octant's near child) and ``miss`` (next node in that octant's
    depth-first order).  A ray's walk state is one int32.  Every leaf owns
    exactly ``LEAF_SIZE`` triangle slots, padded with degenerate triangles
    that cannot be hit.  Int lanes of ``packed_nodes`` and ``leaf_geom``
    are float32 bit patterns, read with ``.view(torch.int32)``."""

    nodes_box: torch.Tensor  # (M, 8) f32: min.xyz, max.xyz, 0, 0
    node_first_tri: torch.Tensor  # (M,) int32: leaf -> first padded-tri slot; inner -> -1
    hit_link: torch.Tensor  # (8, M) int32 per-octant next-on-hit (-1 = done)
    miss_link: torch.Tensor  # (8, M) int32 per-octant next-on-miss (-1 = done)
    tri_geom: torch.Tensor  # (Tpad, 9) f32: v0, e1, e2 per padded leaf slot
    tri_id: torch.Tensor  # (Tpad,) int32: triangle index in leaf order, -1 = pad
    # one row per (octant, node): [bmin(3), bmax(3), leaf_row | -1, hit, miss]
    packed_nodes: torch.Tensor  # (8*M, 9) f32 (lanes 6..8 int32 bit patterns)
    leaf_geom: torch.Tensor  # (L, 40) f32: 4 tris x (v0, e1, e2) + 4 int32 ids

    @property
    def num_nodes(self) -> int:
        return self.node_first_tri.shape[0]


class Materials(NamedTuple):
    """PBR material table, SoA over M."""

    bsdf: torch.Tensor  # (M,) int32: BSDF_*
    base_color: Vec3
    emission: Vec3
    roughness: torch.Tensor
    metalness: torch.Tensor
    ior: torch.Tensor
    k: torch.Tensor  # extinction for conductors
    # texture ids into the atlas; INVALID_ID = constant parameter
    base_color_tex: torch.Tensor  # (M,) int32
    emission_tex: torch.Tensor
    roughness_tex: torch.Tensor
    metalness_tex: torch.Tensor
    normal_tex: torch.Tensor
    mask_tex: torch.Tensor  # stored for the schema; nothing reads it (as in the reference)
    normal_strength: torch.Tensor  # (M,)
    # spectral dispersion (read in spectral mode only): ior(lambda) = IoR +
    # C / lambda_um^2 + D / lambda_um^4, or, where ``disp_use_abbe``, the
    # Cauchy form fitted to (IoR, abbe)
    dispersive: torch.Tensor  # (M,) bool
    abbe: torch.Tensor  # (M,) Abbe number V_d
    dispersion_c: torch.Tensor  # (M,) Cauchy C (um^2)
    dispersion_d: torch.Tensor  # (M,) Cauchy D (um^4)
    disp_use_abbe: torch.Tensor  # (M,) bool: the abbe form instead of C / D


class Lights(NamedTuple):
    """All lights, SoA over L."""

    kind: torch.Tensor  # (L,) int32: LIGHT_*
    color: Vec3
    rot: Rot3
    trans: Vec3
    shape_kind: torch.Tensor  # (L,) int32 SHAPE_*
    shape_param: Vec3  # rect/box: half-size; sphere: (radius,-,-)
    area: torch.Tensor
    cos_angle: torch.Tensor  # spot/directional cone cosine
    is_delta: torch.Tensor  # bool
    is_finite: torch.Tensor  # bool
    env_tex: torch.Tensor  # (L,) int32 texture id for background lights


@dataclasses.dataclass(frozen=True)
class Camera:
    """Perspective camera with thin-lens DoF and motion blur: 0-d tensors on
    the scene's device, plus the static feature toggles as plain fields.
    The ``*_end`` pose is the camera at shutter close (time 1); a ray at
    time t sees the lerp of the two poses, re-orthonormalized."""

    origin: Vec3
    right: Vec3  # transform row 0
    up: Vec3  # transform row 1
    forward: Vec3  # transform row 2
    tan_half_fov: torch.Tensor
    aspect: torch.Tensor
    aperture: torch.Tensor
    focal_distance: torch.Tensor
    distortion_const: torch.Tensor
    distortion_variable: torch.Tensor
    origin_end: Vec3
    right_end: Vec3
    up_end: Vec3
    forward_end: Vec3
    enable_dof: bool = False  # thin lens
    bokeh_shape: int = 0  # scene/camera.py BOKEH_*: the aperture's shape
    aperture_blades: int = 5  # sides of the BOKEH_NGON aperture
    enable_distortion: bool = False
    enable_motion_blur: bool = False  # rays with a time use the lerped pose


# texture kinds: bitmap / checkerboard / simplex-noise / mix(A, B, weight) / constant
TEX_BITMAP = 0
TEX_CHECKERBOARD = 1
TEX_NOISE = 2
TEX_MIX = 3
TEX_CONST = 4


class TextureAtlas(NamedTuple):
    """The whole texture system as one SoA table (K textures).  Bitmaps are
    packed row-wise into ONE (rows, W_atlas, 3) tensor so a per-ray fetch is
    one 2-D gather whichever texture each ray addresses; procedural kinds
    are evaluated inline, selected by the per-texture integer ``kind``."""

    data: torch.Tensor  # (rows, W, 3) f32 linear, packed bitmap storage
    y0: torch.Tensor  # (K,) int32 first row of texture k (bitmaps)
    height: torch.Tensor  # (K,) int32
    width: torch.Tensor  # (K,) int32
    filter_mode: torch.Tensor  # (K,) int32: 0 nearest, 1 bilinear, 2 bilinear-smoothstep
    kind: torch.Tensor  # (K,) int32: TEX_*
    color_a: Vec3  # (K,) checkerboard/noise color A, const color
    color_b: Vec3  # (K,) color B
    octaves: torch.Tensor  # (K,) int32 noise FBM octaves
    sub_a: torch.Tensor  # (K,) int32 mix input A texture id
    sub_b: torch.Tensor  # (K,) int32 mix input B texture id
    sub_w: torch.Tensor  # (K,) int32 mix weight texture id
    # static facts of the table, known on the host when it is built: which
    # kinds occur and the most octaves any noise asks for.  The sampler
    # leaves out the work no row can select; the defaults leave nothing out.
    kinds_present: tuple = (TEX_BITMAP, TEX_CHECKERBOARD, TEX_NOISE, TEX_MIX, TEX_CONST)
    max_octaves: int = 8


class Decals(NamedTuple):
    """Projected-texture decals, SoA over D, sorted by descending ``order``.
    A decal is a box in its local space; shading points inside it get base
    color and roughness alpha-blended from the decal's constants and
    textures."""

    rot: Rot3  # local->world rotation rows, (D,) each
    trans: Vec3  # (D,) box center
    half_size: Vec3  # (D,) box half-extents
    base_color: Vec3  # (D,) constant factor
    base_color_tex: torch.Tensor  # (D,) int32 texture id or INVALID_ID
    alpha_tex: torch.Tensor  # (D,) int32 alpha texture (its x channel) or INVALID_ID
    roughness: torch.Tensor  # (D,)
    alpha_min: torch.Tensor  # (D,)
    alpha_max: torch.Tensor  # (D,)

    @property
    def count(self) -> int:
        return self.roughness.shape[0]


class MeshGeom(NamedTuple):
    """One shared OBJECT-SPACE mesh: geometry stored once, referenced by any
    number of instances."""

    tris: Triangles  # object-space triangle table
    clusters: object  # ClusterSet built over the object-space triangles


@dataclasses.dataclass(frozen=True)
class Instances:
    """Instance table: per-instance rigid transform (object -> world) and
    linear velocity over the shutter (at ray time t the translation is
    trans + vel * t).  Rays are transformed into each instance's object
    space and traced through its shared mesh; ``mesh_ids`` is a plain
    tuple, known on the host."""

    rot: Rot3  # object->world rotation rows, (I,) components
    trans: Vec3  # (I,)
    vel: Vec3  # (I,) translation over the shutter interval
    mesh_ids: tuple = ()

    @property
    def count(self) -> int:
        return len(self.mesh_ids)


class SceneData(NamedTuple):
    """Complete device-side scene."""

    prims: Primitives
    tris: Optional[Triangles]
    materials: Materials
    lights: Lights
    clusters: object = None  # Optional[ClusterSet] (wave2 mesh traversal)
    textures: Optional[TextureAtlas] = None
    # Optional[Distribution2D] over the background light's lat-long bitmap
    # (luminance x sin(theta)): NEE importance-samples it
    env_dist: object = None
    bvh: Optional[BVHFlat] = None  # skip-link BVH over ``tris`` (the ``bvh`` mode)
    decals: Optional[Decals] = None
    # shared object-space meshes and their instances (two-level structure);
    # baked world-space ``tris`` and instanced meshes can coexist
    mesh_geoms: tuple = ()
    instances: Optional[Instances] = None


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (hashable) scene metadata used for host-side dispatch."""

    light_kinds: tuple = ()
    light_is_delta: tuple = ()
    n_lights: int = 0  # real lights (0 if only the dummy placeholder exists)
    background_light_index: int = -1
    scene_radius: float = 30.0
