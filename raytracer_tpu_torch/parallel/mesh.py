"""Multi-device rendering over ``torch.distributed`` (port of
``raytracer_tpu/parallel/mesh.py``).

One process per device, each a rank of a process group:

- a 1-D device mesh ``"tiles"`` over the world (``make_mesh``), or a 2-D
  ``("hosts", "chips")`` mesh (``make_multihost_mesh``); a rank's band is
  its flat index, row-major over the mesh;
- the scene is replicated: every rank holds the whole scene;
- the film is split by pixel rows: each rank renders and accumulates its
  own band (``film_sharding``), so a render pass needs no collective on the
  film; ``gather_film`` assembles the whole film where it is wanted;
- the pass counters and the material gradients are summed over the group
  (``all_reduce_sum``); VCM sums its light-tracing splat frame and gathers
  its photons in rank order (``all_gather_cat``);
- samples are pure hashes of the global pixel id, pass and seed, so an
  N-rank render and a one-rank render of the same pass give the same film.

The backend is the caller's choice, and the collectives never switch it.
NCCL takes CUDA tensors as they are.  A gloo group meeting CUDA tensors (as
when two ranks share one card, which NCCL refuses) goes through the host:
the helpers copy the tensor to the host, run the collective there and copy
the result back, and count those bytes in ``STATS.host_bytes``.

``train_step`` is the one-device body of ``train_step_sharded``: the loss
of a rendered image against a target and its gradients with respect to the
three material tables.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..integrators.path_tracer import Counters, RenderParams
from ..math.vec import Vec3
from ..render.film import Film, accumulate_frame
from ..render.renderer import ViewportParams, trace_rows
from ..scene.types import Camera, SceneData, SceneMeta
from ..utils.profiler import span

AXIS = "tiles"
HOST_AXIS = "hosts"
CHIP_AXIS = "chips"


class CollectiveStats:
    """What the collective helpers moved: ``host_bytes`` counts the bytes a
    gloo group's CUDA tensors were copied between the device and the host,
    both ways."""

    host_bytes = 0


STATS = CollectiveStats()


def init_distributed(init_method: str, world_size: int, rank: int, backend: str):
    """Join the process group (one call per process, before any collective).

    ``init_method`` is where the ranks meet (``tcp://host:port`` or a
    ``file://`` path every rank can reach), ``backend`` ``"nccl"`` or
    ``"gloo"``.  Touches nothing else, and does nothing when this process
    has already joined a group."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh():
    """1-D device mesh over the world, axis ``"tiles"``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),), mesh_dim_names=(AXIS,))


def make_multihost_mesh():
    """``("hosts", "chips")`` mesh: one row of ``LOCAL_WORLD_SIZE`` ranks a
    host, as a launcher such as torchrun sets it (unset: the whole world on
    one host)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    per = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per:
        raise ValueError(f"uneven devices per host: world {world}, {per} a host")
    return init_device_mesh(_mesh_device_type(), (world // per, per), mesh_dim_names=(HOST_AXIS, CHIP_AXIS))


def _flat_index(mesh) -> int:
    """This rank's linear index across the mesh's axes, row-major."""
    coord = mesh.get_coordinate()
    idx = coord[0]
    for a in range(1, mesh.ndim):
        idx = idx * mesh.size(a) + coord[a]
    return idx


def _mesh_group(mesh):
    """The process group over every rank of ``mesh``, in flat-index order."""
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    elif mesh.size() == dist.get_world_size():
        group = dist.group.WORLD
    else:
        raise ValueError("a mesh of more than one axis must span the world")
    if dist.get_rank(group) != _flat_index(mesh):
        raise ValueError("the mesh's flat index and the group's rank order differ")
    return group


def _band(mesh, height: int) -> tuple[int, int]:
    """(row0, rows) of this rank's band of an image ``height`` rows high."""
    n_dev = mesh.size()
    if height % n_dev:
        raise ValueError(f"height {height} % devices {n_dev} != 0")
    rows = height // n_dev
    return _flat_index(mesh) * rows, rows


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, as a new tensor on ``t``'s device.
    A gloo group's CUDA tensor is copied to the host, reduced there and
    copied back (counted in ``STATS.host_bytes``)."""
    if _staged(t, group):
        h = t.detach().cpu()
        dist.all_reduce(h, group=group)
        STATS.host_bytes += 2 * h.nbytes
        return h.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along the
    first axis in rank order: ``all_gather(..., tiled=True)``.  A gloo
    group's CUDA tensor is copied to the host, gathered there and the result
    copied back (counted in ``STATS.host_bytes``)."""
    staged = _staged(t, group)
    src = t.detach().cpu() if staged else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, 0)
    if staged:
        STATS.host_bytes += src.nbytes + out.nbytes
        out = out.to(t.device)
    return out


def film_sharding(film: Film, mesh) -> Film:
    """This rank's band of the whole film ``film``: its rows of both sums
    (its own copy), the pass counters as they are."""
    row0, rows = _band(mesh, film.sum.shape[0])
    return film._replace(sum=film.sum[row0:row0 + rows].clone(),
                         secondary_sum=film.secondary_sum[row0:row0 + rows].clone())


def gather_film(film: Film, mesh) -> Film:
    """The whole film, on every rank, from each rank's band: an all-gather
    of both sums in flat-index order."""
    group = _mesh_group(mesh)
    return film._replace(sum=all_gather_cat(film.sum, group), secondary_sum=all_gather_cat(film.secondary_sum, group))


def _reduce_counters(counters: Counters, group) -> Counters:
    """The counters summed over the group, in one collective."""
    present = [i for i, c in enumerate(counters) if c is not None]
    summed = all_reduce_sum(torch.stack([counters[i] for i in present]), group)
    out = list(counters)
    for k, i in enumerate(present):
        out[i] = summed[k]
    return Counters(*out)


@torch.no_grad()
def render_pass_sharded(scene: SceneData, meta: SceneMeta, cam: Camera, film: Film, pass_idx: int, halton,
                        vp: ViewportParams, params: RenderParams, mesh):
    """One accumulation pass of this rank's band (``film`` is the band,
    ``film_sharding``).  The film takes no collective; the counters are
    summed over the mesh, so every rank returns the whole frame's."""
    row0, rows = _band(mesh, vp.height)
    radiance, counters = trace_rows(scene, meta, cam, pass_idx, halton, vp, params, rows=rows, row0=row0)
    film = accumulate_frame(film, radiance, use_secondary=(pass_idx % 2 == 0))
    return film, _reduce_counters(counters, _mesh_group(mesh))


def render_pass_vcm_sharded(scene: SceneData, meta: SceneMeta, cam: Camera, film: Film, pass_idx: int,
                            vp: ViewportParams, params: RenderParams, mesh, vcm=None):
    """One VCM pass of this rank's band: its light and camera sub-paths,
    the light-tracing splat frame summed over the mesh, the photons gathered
    from every rank before the grid build (``render_pass_vcm`` with a
    group)."""
    from ..integrators.vcm import VcmParams, render_pass_vcm

    vcm = vcm if vcm is not None else VcmParams()
    row0, rows = _band(mesh, vp.height)
    return render_pass_vcm(scene, meta, cam, film, pass_idx, None, vp, params, vcm, rows=rows, row0=row0,
                           axis_name=_mesh_group(mesh))


def material_leaves(scene: SceneData):
    """(scene, leaves): the scene with its three differentiated material
    tables (``base_color``, ``emission``, ``roughness``) replaced by leaves
    that require grad, and the 7 leaves in that order.  A leaf shares the
    caller's storage, so the caller's tensors gain no ``.grad`` and no
    ``requires_grad``."""
    m = scene.materials
    flat = [c.detach().requires_grad_() for c in (*m.base_color, *m.emission, m.roughness)]
    mats = m._replace(base_color=Vec3(*flat[0:3]), emission=Vec3(*flat[3:6]), roughness=flat[6])
    return scene._replace(materials=mats), flat


def _band_step(scene, meta, cam, target_band, pass_idx, vp, params, rows, row0):
    """The loss of the band of ``rows`` rows at ``row0`` over the GLOBAL
    pixel count, and its gradients with respect to the 7 material leaves."""
    s, flat = material_leaves(scene)
    with span("train.forward"):
        radiance, _ = trace_rows(s, meta, cam, pass_idx, None, vp, params, rows=rows, row0=row0)
    with span("train.loss"):
        img = torch.stack([c.reshape(rows, vp.width) for c in radiance], dim=-1)
        loss = torch.sum((img - target_band) ** 2) / (vp.width * vp.height * 3)
    with span("train.backward"):
        # a table the image does not reach gets zeros, as jax.grad gives
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return loss.detach(), grads


def _as_tables(g):
    return Vec3(*g[0:3]), Vec3(*g[3:6]), g[6]


def train_step(scene: SceneData, meta: SceneMeta, cam: Camera, target: torch.Tensor, pass_idx: int,
               vp: ViewportParams, params: RenderParams):
    """One forward + backward pass.  ``target`` is the (H, W, 3) reference
    image.  Returns (loss, (g_base_color, g_emission, g_roughness)): the loss
    ``sum((img - target)**2) / (W*H*3)`` as a 0-d tensor, the gradients as
    the tables' own structure (``Vec3`` / tensor), all detached."""
    loss, g = _band_step(scene, meta, cam, target, pass_idx, vp, params, vp.height, 0)
    return loss, _as_tables(g)


def train_step_sharded(scene: SceneData, meta: SceneMeta, cam: Camera, target: torch.Tensor, pass_idx: int,
                       vp: ViewportParams, params: RenderParams, mesh):
    """``train_step`` over the mesh: each rank the loss of its band of the
    (H, W, 3) ``target`` over the global pixel count and its gradients,
    then one all-reduce of the loss and the 7 gradient leaves.  Every rank
    returns the whole image's loss and gradients."""
    row0, rows = _band(mesh, vp.height)
    loss, g = _band_step(scene, meta, cam, target[row0:row0 + rows], pass_idx, vp, params, rows, row0)
    sizes = [x.numel() for x in g]
    summed = all_reduce_sum(torch.cat([loss.reshape(1), *(x.reshape(-1) for x in g)]), _mesh_group(mesh))
    parts = torch.split(summed[1:], sizes)
    return summed[0], _as_tables([p.reshape(x.shape) for p, x in zip(parts, g)])
