"""wave2 sort-join mesh traversal (port of ``raytracer_tpu/ops/wave2_traverse.py``).

Exact closest-hit / any-hit over a ``ClusterSet`` for a whole wavefront:

0. ``_wave2_trace``: rays with work (t_max != 0) are compacted to the front
   by one stable sort and traced in windows of ``SUBWAVE`` rays.
1. ``_p1_extract``: slab test of every ray against every super-cluster
   box; each ray takes its ``kc`` smallest overlapped super ids above its
   cursor, ascending (the reference bit-packs the hit matrix on the TPU's
   matrix unit; only its result is ported): the hand-written CUDA kernel
   ``csrc/wave2_extract.cu`` on the card, its plain twin
   ``p1_extract_reference`` (dense (rays x Cs) blocks) on the CPU.
   ``_p1_extract_ftb`` (``RT_WAVE2_FTB=1``, front to back, plain PyTorch
   on every device): each overlap gets one int32 key
   ``(bits(t_enter) >> id_bits) << id_bits | super``, and each ray takes its
   ``kc`` least keys above its cursor key, nearest first, with a lower bound
   on the next one's entry distance for early termination.
2. ``_pair_join``: one stable sort of the (ray, super) pairs on the key
   ``super << shift | octant | origin Morton``; every super's run is
   filler-padded to whole ``CHUNK``-pair chunks, so no chunk crosses supers
   and nothing is dropped; ``block_cluster`` names each chunk's super.  On
   the card ``csrc/wave2_join.cu`` computes the keys, the runs and each
   pair's padded slot by arithmetic around the one sort; the plain twin
   ``pair_join_reference`` (the reference's second sort, cummax and cumsum)
   runs on the CPU.
3. ``mt_chunks``: Möller-Trumbore per chunk — the hand-written CUDA kernel
   ``csrc/wave2_mt.cu`` on the card, its plain PyTorch twin on the CPU.
4. ``_select``: each ray's least t, ties to the lowest tri id, its new
   cursor and whether it is resolved.  On the card one thread a ray reads
   its results through the join's ``slot_of_pair``; the plain twin
   ``select_reference`` sorts them back to ray order (the reference's third
   sort) and takes a dense (N, kc) masked min.
5. ``_window_trace``: unresolved rays (a nearer unvisited candidate may
   exist) are compacted into ``NSUB``-ray sub-wavefronts and traced again
   until none remain — the exactness guarantee.

Settings, read from the environment as the reference reads them:
``RT_WAVE2_CHUNK`` (pairs per chunk, a multiple of 128; sets ``ROWS``, the
kernel's rows per chunk) and ``RT_WAVE2_NSUB`` at import;
``RT_WAVE2_FTB`` and ``RT_WAVE2_KC`` when ``wave2_closest_hit`` or
``wave2_any_hit`` is called; ``RT_WAVE2_SPATIAL_KEY=0`` (the pair key
without its octant and Morton part) and the diagnostic
``RT_WAVE2_SKIP_KERNEL`` (the sort-join runs, the kernel does not, every
chunk reports "processed, no hit") at each round.  ``STATS`` counts the
windows, rounds, continuation iterations, pair slots and host syncs.

The stages keep the reference's padding and ordering so the two packages
can be compared stage by stage.  The reference's ``lax.while_loop`` trip
counts, computed on the device, become python loops with one ``.item()``
per window and per continuation round.  Traversal is detached from the
autograd graph, as in the reference.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..math.vec import Vec3
from ..scene.clusters import SUB_PER_SUPER, ClusterSet
from ..utils.logger import log_info, log_warning
from ..utils.profiler import count, count_device, host_sync, span, tracing
from .cluster_traverse import slab_inv as _inv
from .cuda_build import launch
from .intersect import BIG

TRI_EPS = 1e-7
HIT_EPS = 1e-4
CHUNK = int(os.environ.get("RT_WAVE2_CHUNK", "1024"))  # pairs per MT work chunk
if CHUNK <= 0 or CHUNK % 128:
    raise ValueError(f"RT_WAVE2_CHUNK={CHUNK}: a chunk is whole rows of 128 pairs")
ROWS = CHUNK // 128  # rows of 128 pairs per chunk: the kernel's blocks per chunk
NSUB = int(os.environ.get("RT_WAVE2_NSUB", "16384"))  # continuation sub-wavefront size
if (CHUNK, NSUB) != (1024, 16384):
    log_info("wave2: CHUNK %d (%d rows), NSUB %d from the environment", CHUNK, ROWS, NSUB)
SUBWAVE = 65536  # rays per traced window
KC = 16  # candidate supers per ray per round, id order
KC_FTB = 4  # the same, front to back: most rays resolve on their few nearest supers
BIGF = 3.0e38
IMAX = 2**31 - 1
_P1_CHUNK_ELEMS = 1 << 26  # bound on one (rays x Cs) slab-test block

# windows traced, rounds run (first and continuation), continuation
# iterations, the most in one window, (ray, candidate) pair slots, host syncs
STATS = dict.fromkeys(("windows", "rounds", "continuations", "max_window_continuations", "pair_slots",
                       "host_syncs"), 0)
_SWITCHES = {}  # ablation switch -> the value it was last read with


def reset_stats():
    for key in STATS:
        STATS[key] = 0


def ablation_switch(name: str) -> bool:
    """A diagnostic switch of the environment (``RT_WAVE2_SKIP_KERNEL``,
    ``RT_SKIP_TRI_FRAME``): on when set to a non-empty value, as in the
    reference.  Logged whenever it is read with another value than before."""
    value, before = os.environ.get(name, ""), _SWITCHES.get(name)
    if before != value:
        _SWITCHES[name] = value
        if value:
            log_warning("%s=%s: diagnostic ablation on; answers are not the renderer's", name, value)
        elif before:
            log_info("%s off", name)
    return bool(value)


def _key_shift(cs: int) -> int:
    """Shift of the super id in the pair key; keeps the key inside int32."""
    return max(0, min(21, 31 - max(1, int(cs + 1).bit_length())))


def _id_bits(cs: int) -> int:
    """Bits of the super id in a front-to-back key."""
    return max(1, int(cs).bit_length())


def _stable_sort(key, *payloads):
    """``lax.sort(num_keys=1)``: stable sort on ``key``, payloads ride along."""
    sk, perm = torch.sort(key, stable=True)
    return (sk,) + tuple(p[perm] for p in payloads)


def _arange(n, like):
    return torch.arange(n, dtype=torch.int32, device=like.device)


# --------------------------------------------------------------------------
# Phase 1: per-ray candidate extraction over super-cluster boxes
# --------------------------------------------------------------------------


def _slab(box, ox, oy, oz, ix, iy, iz):
    """(tmin, tmax) of the (rows, 1) rays against every (Cs, 6) box: (rows, Cs) each."""
    t1x = (box[None, :, 0] - ox) * ix
    t2x = (box[None, :, 3] - ox) * ix
    t1y = (box[None, :, 1] - oy) * iy
    t2y = (box[None, :, 4] - oy) * iy
    t1z = (box[None, :, 2] - oz) * iz
    t2z = (box[None, :, 5] - oz) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z))
    return tmin, tmax


def p1_extract_reference(cs_set: ClusterSet, ox, oy, oz, dx, dy, dz, tl, cursor, kc: int):
    """Plain PyTorch twin of ``csrc/wave2_extract.cu``: (N,) rays -> (cand
    (N, kc) ascending super ids with ``hit & id > cursor``, padded with Cs;
    remaining (N,) = max(total - kc, 0))."""
    n = ox.shape[0]
    cs = cs_set.num_supers
    box = cs_set.super_box
    cid = _arange(cs, ox)[None, :]
    ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
    rows = max(1, _P1_CHUNK_ELEMS // max(cs, 1))
    cands, rems = [], []
    for a in range(0, n, rows):
        col = lambda v: v[a:a + rows, None]
        tmin, tmax = _slab(box, col(ox), col(oy), col(oz), col(ix), col(iy), col(iz))
        ent = torch.clamp_min(tmin, 0.0)
        # tl's SIGN encodes per-ray any-hit mode; the limit is |tl|
        hit = (tmax >= ent) & (ent < torch.abs(col(tl))) & (cid > col(cursor))
        ids = torch.where(hit, cid, cs)
        cands.append(torch.topk(ids, kc, dim=1, largest=False, sorted=True).values)
        rems.append(torch.clamp_min(hit.sum(1, dtype=torch.int32) - kc, 0))
    return torch.cat(cands), torch.cat(rems)


def _p1_extract(cs_set: ClusterSet, ox, oy, oz, dx, dy, dz, tl, cursor, kc: int):
    """Candidate extraction (``p1_extract_reference`` says what it returns).
    CPU tensors take the plain twin; CUDA tensors launch
    ``csrc/wave2_extract.cu`` or raise.  Counts ``wave2.box_tests`` (rays x
    Cs)."""
    n, cs = ox.shape[0], cs_set.num_supers
    count("wave2.box_tests", n * cs)
    dev = ox.device
    if dev.type == "cpu":
        return p1_extract_reference(cs_set, ox, oy, oz, dx, dy, dz, tl, cursor, kc)
    if dev.type != "cuda":
        raise ValueError(f"_p1_extract: unsupported device {dev}")
    box = cs_set.super_box
    rays = (ox, oy, oz, dx, dy, dz, tl)
    ins = (box, *rays, cursor)
    ok = (
        box.dtype == torch.float32 and tuple(box.shape) == (cs, 6) and cs > 0 and kc > 0
        and all(a.dtype == torch.float32 and tuple(a.shape) == (n,) for a in rays)
        and cursor.dtype == torch.int32 and tuple(cursor.shape) == (n,)
        and all(a.device == dev and a.is_contiguous() for a in ins)
    )
    if not ok:
        raise ValueError("_p1_extract: inputs do not match the kernel's dtypes, shapes, device or layout")
    # one allocation for both results: cand (n, kc), then rem (n,)
    out = torch.empty((n * (kc + 1),), dtype=torch.int32, device=dev)
    cand, rem = out[:n * kc].view(n, kc), out[n * kc:]
    launch("wave2_extract", "wave2_extract_launch", *ins, cand, rem, n, cs, kc, device=dev)
    return cand, rem


def _p1_extract_ftb(cs_set: ClusterSet, ox, oy, oz, dx, dy, dz, tl, cur_key, kc: int):
    """Front-to-back extraction: (N,) rays -> (cand (N, kc) the super ids of
    each ray's ``kc`` least keys above ``cur_key``, nearest first, padded
    with Cs; next_t (N,) the entry distance of the next key, floored to its
    quantization, +inf when none; last (N,) the last key emitted, else
    ``cur_key``).  A key is ``(bits(t_enter) >> id_bits) << id_bits | super``
    in int32: the bits of a non-negative float32 order as its value, so key
    order is distance order, ties to the lower id.  The reference peels
    ``kc + 1`` minima one by one; the keys of a ray are distinct, so its
    ``kc + 1`` least keys in order (``topk``) are the same values."""
    n = ox.shape[0]
    cs = cs_set.num_supers
    idb = _id_bits(cs)
    box = cs_set.super_box
    cid = _arange(cs, ox)[None, :]
    ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
    rows = max(1, _P1_CHUNK_ELEMS // max(cs, 1))
    take = min(kc + 1, cs)
    cands, nexts, lasts = [], [], []
    for a in range(0, n, rows):
        col = lambda v: v[a:a + rows, None]
        tmin, tmax = _slab(box, col(ox), col(oy), col(oz), col(ix), col(iy), col(iz))
        # + 0.0 turns a -0.0 entry into +0.0, as XLA's max(-0.0, 0.0) does
        # and torch's clamp does not: the key reads the bits
        ent = torch.clamp_min(tmin, 0.0) + 0.0
        hit = (tmax >= ent) & (ent < torch.abs(col(tl)))
        key = ((ent.view(torch.int32) >> idb) << idb) | cid
        kmat = torch.where(hit & (key > col(cur_key)), key, IMAX)
        least = torch.topk(kmat, take, dim=1, largest=False, sorted=True).values
        if take <= kc:  # fewer supers than kc + 1: the missing keys are empty
            least = torch.cat([least, least.new_full((least.shape[0], kc + 1 - take), IMAX)], 1)
        got = least[:, :kc] < IMAX
        cands.append(torch.where(got, least[:, :kc] & ((1 << idb) - 1), cs))
        lasts.append(torch.where(got, least[:, :kc], col(cur_key)).amax(1))
        nxt = least[:, kc]
        nexts.append(torch.where(nxt < IMAX, ((nxt >> idb) << idb).view(torch.float32), float("inf")))
    return torch.cat(cands), torch.cat(nexts), torch.cat(lasts)


# --------------------------------------------------------------------------
# Phase 2: sort-join into single-super chunks
# --------------------------------------------------------------------------


class PairJoin(NamedTuple):
    sidx: torch.Tensor  # (p_pad,) pair slot at each stage-1 sorted position (p = pad)
    fidx: torch.Tensor  # (d_len,) pair slot at each padded position (>= p: pad/filler)
    pairs: tuple  # 7 x (B2, ROWS, 128) f32: ox, oy, oz, dx, dy, dz, tl per pair
    block_cluster: torch.Tensor  # (B2,) int32 super id per chunk (Cs = sentinel)
    slot_of_pair: torch.Tensor = None  # (p,) int32 padded position of each pair (the kernels'; the twin's None)


def _spatial_key_shift(cs: int) -> int:
    """The pair key's shift: ``_key_shift``, or 0 under ``RT_WAVE2_SPATIAL_KEY=0``
    (the key is then the super id alone)."""
    return _key_shift(cs) if os.environ.get("RT_WAVE2_SPATIAL_KEY", "1") != "0" else 0


def _filler_budget(cs: int) -> int:
    """Filler slots a join hands on besides the p_pad pairs: room for every
    super's run to be padded to whole chunks (a CHUNK multiple)."""
    return -(-(cs * (CHUNK - 1)) // CHUNK) * CHUNK


def pair_join_reference(cs_set: ClusterSet, cand, ox, oy, oz, dx, dy, dz, tl) -> PairJoin:
    """Plain PyTorch twin of ``csrc/wave2_join.cu``'s key, runs and place
    launches (the reference's two sorts, cummax and cumsum)."""
    n, kc = cand.shape
    cs = cs_set.num_supers
    p = n * kc
    p_pad = -(-p // CHUNK) * CHUNK

    # composite key (super id | ray octant | ray origin Morton): chunks stay
    # single-super while each chunk's rows become spatially and
    # directionally coherent, so the kernel's per-(row, sub) gate culls
    key_shift = _spatial_key_shift(cs)
    mbits = max(0, key_shift - 3)
    box = cs_set.super_box
    valid_s = box[:, 0] <= box[:, 3]
    glo = [torch.where(valid_s, box[:, i], float("inf")).min() for i in range(3)]
    ghi = [torch.where(valid_s, box[:, 3 + i], float("-inf")).max() for i in range(3)]
    bpa = mbits // 3  # Morton bits per axis
    top = float(2 ** bpa - 1)

    def qb(x, lo, hi):
        return torch.clamp((x - lo) / torch.clamp_min(hi - lo, 1e-9) * top, 0.0, top).to(torch.int32)

    qx, qy, qz = qb(ox, glo[0], ghi[0]), qb(oy, glo[1], ghi[1]), qb(oz, glo[2], ghi[2])
    morton = torch.zeros_like(qx)
    for b in range(bpa):
        morton = (morton | (((qx >> b) & 1) << (3 * b)) | (((qy >> b) & 1) << (3 * b + 1))
                  | (((qz >> b) & 1) << (3 * b + 2)))
    octant = ((dx < 0).to(torch.int32) | ((dy < 0).to(torch.int32) << 1)
              | ((dz < 0).to(torch.int32) << 2))
    okey = ((octant << mbits) | morton) if key_shift >= 3 else torch.zeros_like(morton)
    sentinel = cs << key_shift
    key = torch.where(cand < cs, (cand << key_shift) | okey[:, None], sentinel).reshape(p)
    pad = lambda x, fill: torch.cat([x, x.new_full((p_pad - p,), fill)])
    sk, sidx = _stable_sort(pad(key, sentinel), pad(_arange(p, cand), p))

    # filler-padded destinations: every super's pair run is padded to CHUNK
    # multiples so each chunk belongs to exactly one super
    start = torch.searchsorted(sk, (_arange(cs + 1, sk) << key_shift) - 1, right=True, out_int32=True)
    pos = _arange(p_pad, sk)
    is_start = torch.cat([sk.new_ones(1, dtype=torch.bool), (sk[1:] >> key_shift) != (sk[:-1] >> key_shift)])
    run_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
    prev_start = torch.cat([pos.new_zeros(1), run_start[:-1]])
    prev_len = pos - prev_start  # at a run start: length of the PREVIOUS run
    v_p = torch.where(is_start & (pos > 0), (-prev_len) % CHUNK, 0)
    cum_pad = torch.cumsum(v_p, 0, dtype=torch.int32)
    d_p = pos + cum_pad  # padded destination of each pair (ascending)

    cp_at = cum_pad[torch.clamp_max(start, p_pad - 1).long()]
    d_c = start + cp_at  # (Cs+1,) padded start of each super's region
    len_c = start[1:] - start[:-1]
    pad_c = (-len_c) % CHUNK
    gap_start = d_c[:cs] + len_c
    f = _filler_budget(cs)
    d_len = p_pad + f
    if tracing():  # slots handed to the sort, the gathers and the kernel, and the pairs among them
        count("wave2.pair_slots_sent", d_len)
        count_device("wave2.pair_slots_real", start[cs])
    jj = _arange(CHUNK - 1, sk)[None, :]
    fill_key = torch.where(jj < pad_c[:, None], gap_start[:, None] + jj, 2 ** 30).reshape(-1)
    fill_key = torch.cat([fill_key, fill_key.new_full((f - fill_key.shape[0],), 2 ** 30)])
    _, fidx = _stable_sort(torch.cat([d_p, fill_key]), torch.cat([sidx, sidx.new_full((f,), p_pad)]))

    # per-pair ray payloads; pads and fillers ride as (o=0, d=+x, tl=0)
    real = fidx < p
    ray = torch.where(real, fidx // kc, 0).long()
    b2 = d_len // CHUNK
    ride = lambda a, fill: torch.where(real, a[ray], fill).reshape(b2, ROWS, 128)
    pairs = (ride(ox, 0.0), ride(oy, 0.0), ride(oz, 0.0),
             ride(dx, 1.0), ride(dy, 0.0), ride(dz, 0.0), ride(tl, 0.0))

    # chunk b sits in the region of the super whose padded start is the last
    # one <= CHUNK*b (the sentinel region maps to Cs)
    block_cluster = torch.searchsorted(d_c, _arange(b2, d_c) * CHUNK, right=True, out_int32=True) - 1
    block_cluster = torch.clamp(torch.clamp_max(block_cluster, cs), 0, cs)
    return PairJoin(sidx, fidx, pairs, block_cluster)


def _pair_join(cs_set: ClusterSet, cand, ox, oy, oz, dx, dy, dz, tl) -> PairJoin:
    """Sort-join of the (N, kc) candidates into single-super chunks
    (``pair_join_reference`` says what it returns).  CPU tensors take the
    plain twin; CUDA tensors launch ``csrc/wave2_join.cu``'s key, runs and
    place kernels around one ``torch.sort`` or raise.  The kernels' join
    also gives ``slot_of_pair``, which the select reads back through."""
    dev = cand.device
    if dev.type == "cpu":
        return pair_join_reference(cs_set, cand, ox, oy, oz, dx, dy, dz, tl)
    if dev.type != "cuda":
        raise ValueError(f"_pair_join: unsupported device {dev}")
    n, kc = cand.shape
    cs = cs_set.num_supers
    box = cs_set.super_box
    rays = (ox, oy, oz, dx, dy, dz, tl)
    ok = (
        cand.dtype == torch.int32 and box.dtype == torch.float32 and tuple(box.shape) == (cs, 6) and cs > 0
        and all(a.dtype == torch.float32 and tuple(a.shape) == (n,) for a in rays)
        and all(a.device == dev and a.is_contiguous() for a in (cand, box, *rays))
    )
    if not ok:
        raise ValueError("_pair_join: inputs do not match the kernels' dtypes, shapes, device or layout")
    p = n * kc
    p_pad = -(-p // CHUNK) * CHUNK
    d_len = p_pad + _filler_budget(cs)
    b2 = d_len // CHUNK
    key_shift = _spatial_key_shift(cs)

    key = torch.empty((p_pad,), dtype=torch.int32, device=dev)
    launch("wave2_join", "wave2_join_key_launch", box, cand, *rays[:6], key, n, kc, cs, p_pad, key_shift, device=dev)
    sk, perm = torch.sort(key, stable=True)
    runs = torch.empty((2, cs + 1), dtype=torch.int32, device=dev)  # start, then dstart
    start, dstart = runs[0], runs[1]
    launch("wave2_join", "wave2_join_runs_launch", sk, start, dstart, p_pad, cs, key_shift, CHUNK, device=dev)
    if tracing():  # as the twin counts them
        count("wave2.pair_slots_sent", d_len)
        count_device("wave2.pair_slots_real", start[cs])
    # one allocation each for the int32 results and the seven pair planes
    ints = torch.empty((p_pad + d_len + b2 + p,), dtype=torch.int32, device=dev)
    sidx, fidx, block_cluster, slot_of_pair = torch.split(ints, (p_pad, d_len, b2, p))
    planes = torch.empty((7, b2, ROWS, 128), dtype=torch.float32, device=dev)
    launch("wave2_join", "wave2_join_place_launch", perm, start, dstart, *rays, sidx, fidx, planes, block_cluster,
           slot_of_pair, b2, kc, p, p_pad, cs, CHUNK, device=dev)
    return PairJoin(sidx, fidx, tuple(planes), block_cluster, slot_of_pair)


# --------------------------------------------------------------------------
# Phase 3: the Möller-Trumbore kernel and its plain twin
# --------------------------------------------------------------------------


def mt_chunks_reference(block_cluster, super_geom, super_sbox, ox, oy, oz, dx, dy, dz, tl,
                        any_hit: bool, stats: dict = None):
    """Plain PyTorch twin of ``csrc/wave2_mt.cu`` (and of the TPU
    ``_mt_kernel``): vectorized over (chunk, 8 triangle slots, row, lane).
    Returns (t, tri, u, v, done), each (B2, ROWS, 128).  ``stats`` receives
    'open_gates', the (chunk, row, sub) gates that pass on these inputs,
    'row_gates', their count per row of the live chunks (n_live, ROWS), and
    'live_chunks', the chunks that name a real super."""
    cs = super_geom.shape[0]
    k = super_geom.shape[1] // SUB_PER_SUPER
    live = (block_cluster < cs)[:, None, None]
    c = torch.clamp(block_cluster, 0, cs - 1).long()
    geom = super_geom[c]  # (B2, 8K, 16)
    sbox = super_sbox[c]  # (B2, 8, 8)
    ah = (tl < 0.0)[:, None]  # any-hit lanes, (B2, 1, R, 128)
    tla = torch.abs(tl)
    mask = tla > 0.0  # filler / pad lanes can never register a hit

    # (B2, R, 8 subs, 128) slab gate; a sub opens for the whole row of 128
    e = lambda a: a[:, :, None, :]
    sb = lambda q: sbox[:, None, :, q, None]
    ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
    t1x, t2x = (sb(0) - e(ox)) * e(ix), (sb(3) - e(ox)) * e(ix)
    t1y, t2y = (sb(1) - e(oy)) * e(iy), (sb(4) - e(oy)) * e(iy)
    t1z, t2z = (sb(2) - e(oz)) * e(iz), (sb(5) - e(oz)) * e(iz)
    bmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    bmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                         torch.maximum(t1z, t2z))
    sub_hit = (bmax >= torch.clamp_min(bmin, 0.0)) & (bmin < e(tla)) & e(mask)
    row_open = sub_hit.any(-1)  # (B2, R, 8)
    if stats is not None:
        stats["open_gates"] = int((row_open & live).sum())
        stats["row_gates"] = row_open[live[:, 0, 0]].sum(-1)
        stats["live_chunks"] = int(live.sum())

    # running best per (triangle slot x pair): dim 1 is the slot
    r = lambda a: a[:, None]
    bt = r(tla).expand(-1, 8, -1, -1).clone()
    btid = torch.full_like(bt, -1.0)
    bu = torch.zeros_like(bt)
    bv = torch.zeros_like(bt)
    rox, roy, roz, rdx, rdy, rdz = r(ox), r(oy), r(oz), r(dx), r(dy), r(dz)
    for s in range(SUB_PER_SUPER):
        gate = row_open[:, None, :, s, None]  # (B2, 1, R, 1)
        for g in range(0, k, 8):
            rows = geom[:, s * k + g: s * k + g + 8]  # (B2, 8, 16)
            col = lambda q: rows[:, :, q, None, None]  # (B2, 8, 1, 1)
            v0x, v0y, v0z = col(0), col(1), col(2)
            e1x, e1y, e1z = col(3), col(4), col(5)
            e2x, e2y, e2z = col(6), col(7), col(8)
            tid = col(9)
            px = rdy * e2z - rdz * e2y
            py = rdz * e2x - rdx * e2z
            pz = rdx * e2y - rdy * e2x
            det = e1x * px + e1y * py + e1z * pz
            okd = torch.abs(det) > TRI_EPS
            inv_det = 1.0 / torch.where(okd, det, 1.0)
            tx, ty, tz = rox - v0x, roy - v0y, roz - v0z
            uu = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            vv = (rdx * qx + rdy * qy + rdz * qz) * inv_det
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            hit = (gate & okd & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                   & (tt > HIT_EPS) & (tid >= 0.0) & (tt < bt))
            tid_b = tid.expand_as(bt)
            if any_hit:
                bt = torch.where(hit, 0.0, bt)
                btid = torch.where(hit, tid_b, btid)
            else:
                # any-hit LANES collapse to t=0 on a hit
                bt = torch.where(hit, torch.where(ah, 0.0, tt), bt)
                btid = torch.where(hit, tid_b, btid)
                bu = torch.where(hit, uu, bu)
                bv = torch.where(hit, vv, bv)

    # fold the 8 slots: min t, ties by lowest tri id
    got = btid >= 0.0
    t_row = torch.where(got, bt, BIGF).amin(1)
    w = got & (bt == t_row[:, None])
    tid_row = torch.where(w, btid, BIGF).amin(1)
    w = w & (btid == tid_row[:, None])
    u_row = torch.where(w, bu, -BIGF).amax(1)
    v_row = torch.where(w, bv, -BIGF).amax(1)
    any_row = live & (tid_row < BIGF)
    t_out = torch.where(any_row, torch.minimum(t_row, tla), tla)
    tri_out = torch.where(any_row, tid_row, -1.0).to(torch.int32)
    u_out = torch.where(any_row, u_row, 0.0)
    v_out = torch.where(any_row, v_row, 0.0)
    done_out = torch.where(live, mask, False).to(torch.int32)
    return t_out, tri_out, u_out, v_out, done_out


def mt_chunks(block_cluster, super_geom, super_sbox, ox, oy, oz, dx, dy, dz, tl, any_hit: bool):
    """Möller-Trumbore over sort-joined pair chunks.  CPU tensors take the
    plain twin; CUDA tensors launch ``csrc/wave2_mt.cu`` or raise."""
    pairs = (ox, oy, oz, dx, dy, dz, tl)
    dev = ox.device
    if dev.type == "cpu":
        return mt_chunks_reference(block_cluster, super_geom, super_sbox, *pairs, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"mt_chunks: unsupported device {dev}")
    b2 = block_cluster.shape[0]
    cs, rows8k, lanes = super_geom.shape
    k = rows8k // SUB_PER_SUPER
    ins = (block_cluster, super_geom, super_sbox) + pairs
    ok = (
        block_cluster.dtype == torch.int32 and block_cluster.dim() == 1
        and super_geom.dtype == torch.float32 and lanes == 16 and k % 8 == 0 and 0 < k <= 128
        and super_sbox.dtype == torch.float32 and tuple(super_sbox.shape) == (cs, SUB_PER_SUPER, 8)
        and all(a.dtype == torch.float32 and tuple(a.shape) == (b2, ROWS, 128) for a in pairs)
        and all(a.device == dev and a.is_contiguous() for a in ins)
        and super_geom.data_ptr() % 16 == 0 and super_sbox.data_ptr() % 16 == 0  # read 16 bytes at a time
    )
    if not ok:
        raise ValueError("mt_chunks: inputs do not match the kernel's dtypes, shapes, device, layout or alignment")
    # one allocation for the five (b2, ROWS, 128) results; tri and done are its int32 views
    out = torch.empty((5, b2, ROWS, 128), dtype=torch.float32, device=dev)
    t, tri, u, v, done = out[0], out[1].view(torch.int32), out[2], out[3], out[4].view(torch.int32)
    launch("wave2_mt", "wave2_mt_launch", *ins, t, tri, u, v, done, b2, ROWS, cs, k, any_hit, device=dev)
    return t, tri, u, v, done


# --------------------------------------------------------------------------
# Phase 4: each ray's winner, cursor and resolution
# --------------------------------------------------------------------------


def select_reference(cs: int, cand, join: PairJoin, outs, tl, cursor, any_hit: bool, ftb: bool, remaining=None,
                     next_t=None, new_key=None):
    """Plain PyTorch twin of ``csrc/wave2_join.cu``'s select launch: the
    chunk results ``outs`` (t, tri, u, v, done) back to ray order by a sort
    on ``join.fidx``, then a dense (N, kc) masked min: the least t, ties to
    the lowest tri id.  ``remaining`` (id order) or ``next_t`` and
    ``new_key`` (front to back) come from the extraction.  Returns (t, tri,
    u, v, new_cursor, unresolved); t == |tl| where no hit."""
    n, kc = cand.shape
    ah_ray = tl < 0.0
    # back to ray-major pair order (pads and fillers carry idx >= p -> tail)
    _, t_p, tri_p, u_p, v_p, done_p = _stable_sort(join.fidx, *(o.reshape(-1) for o in outs))
    p = n * kc
    t_p, tri_p, u_p, v_p, done_p = (x[:p].reshape(n, kc) for x in (t_p, tri_p, u_p, v_p, done_p))

    # dense winner select: min t, ties to the lowest tri id
    slot_valid = cand < cs
    hit = slot_valid & (done_p > 0) & (tri_p >= 0)
    tkey = torch.where(hit, t_p, float("inf"))
    best_t = tkey.amin(1)
    won = tkey == best_t[:, None]
    best_tri = torch.where(won, tri_p, 2 ** 31 - 1).amin(1)
    final = won & (tri_p == best_tri[:, None])
    got_hit = torch.isfinite(best_t)
    best_u = torch.where(got_hit, torch.where(final, u_p, float("-inf")).amax(1), 0.0)
    best_v = torch.where(got_hit, torch.where(final, v_p, float("-inf")).amax(1), 0.0)
    best_tri = torch.where(got_hit, best_tri, -1)
    t_round = torch.where(got_hit, best_t, torch.abs(tl))

    unproc = slot_valid & (done_p == 0)
    any_unproc = unproc.any(1)
    if ftb:
        # no slot is left unprocessed (runs are filler-padded to whole
        # chunks); if one were, the ray would retry from its cursor
        new_cursor = torch.where(any_unproc, cursor, new_key)
        unresolved = any_unproc | (next_t < t_round)
    else:
        min_unproc = torch.where(unproc, cand, cs + 1).amin(1)
        max_extracted = torch.where(slot_valid, cand, -1).amax(1)
        new_cursor = torch.where(any_unproc, min_unproc - 1, torch.maximum(max_extracted, cursor))
        unresolved = any_unproc | (remaining > 0)
    if any_hit:
        unresolved = unresolved & (best_tri < 0)
    unresolved = unresolved & ~(ah_ray & (best_tri >= 0))
    return t_round, best_tri, best_u, best_v, new_cursor, unresolved


def _select(cs: int, cand, join: PairJoin, outs, tl, cursor, any_hit: bool, ftb: bool, remaining=None, next_t=None,
            new_key=None):
    """Each ray's result of a round (``select_reference`` says what it
    returns).  CPU tensors take the plain twin; CUDA tensors launch
    ``csrc/wave2_join.cu``'s select kernel, one thread a ray reading its
    slots through ``join.slot_of_pair``, or raise."""
    dev = cand.device
    if dev.type == "cpu":
        return select_reference(cs, cand, join, outs, tl, cursor, any_hit, ftb, remaining, next_t, new_key)
    if dev.type != "cuda":
        raise ValueError(f"_select: unsupported device {dev}")
    n, kc = cand.shape
    slot = join.slot_of_pair
    ints = (cand, slot, outs[1], outs[4], cursor) + ((new_key,) if ftb else (remaining,))
    floats = (tl, outs[0], outs[2], outs[3]) + ((next_t,) if ftb else ())
    per_ray = (tl, cursor) + ((next_t, new_key) if ftb else (remaining,))
    ok = (
        all(a is not None and a.device == dev and a.is_contiguous() for a in (*ints, *floats))
        and all(a.dtype == torch.int32 for a in ints) and all(a.dtype == torch.float32 for a in floats)
        and tuple(slot.shape) == (n * kc,) and all(tuple(a.shape) == (n,) for a in per_ray)
        and all(a.numel() == outs[0].numel() for a in outs)
    )
    if not ok:
        raise ValueError("_select: inputs do not match the kernel's dtypes, shapes, device or layout "
                         "(its join must come from the kernels)")
    f32 = torch.empty((4, n), dtype=torch.float32, device=dev)  # t, tri (int32 view), u, v
    t_out, tri_out, u_out, v_out = f32[0], f32[1].view(torch.int32), f32[2], f32[3]
    new_cursor = torch.empty((n,), dtype=torch.int32, device=dev)
    unresolved = torch.empty((n,), dtype=torch.bool, device=dev)
    launch("wave2_join", "wave2_join_select_launch", cand, slot, *outs, tl, cursor, remaining, next_t, new_key, t_out,
           tri_out, u_out, v_out, new_cursor, unresolved, n, kc, cs, ftb, any_hit, device=dev)
    return t_out, tri_out, u_out, v_out, new_cursor, unresolved


# --------------------------------------------------------------------------
# One round, the continuation loop and the windowed driver
# --------------------------------------------------------------------------


def _round(cs_set: ClusterSet, ox, oy, oz, dx, dy, dz, tl, cursor, kc: int, any_hit: bool, ftb: bool = False):
    """Extraction + join + MT + winner select on one (N,) wavefront.
    Returns (t, tri, u, v, new_cursor, unresolved); t == |tl| where no hit.
    ``ftb``: front-to-back extraction; ``cursor`` is then the last key
    visited, and a ray is resolved once its next candidate's entry distance
    cannot beat its hit."""
    n = ox.shape[0]
    cs = cs_set.num_supers
    remaining = next_t = new_key = None
    with span("wave2.extract"):
        if ftb:
            cand, next_t, new_key = _p1_extract_ftb(cs_set, ox, oy, oz, dx, dy, dz, tl, cursor, kc)
        else:
            cand, remaining = _p1_extract(cs_set, ox, oy, oz, dx, dy, dz, tl, cursor, kc)
    with span("wave2.join"):
        join = _pair_join(cs_set, cand, ox, oy, oz, dx, dy, dz, tl)
    with span("wave2.mt"):
        if ablation_switch("RT_WAVE2_SKIP_KERNEL"):
            # the reference's stand-in: every chunk "processed, no hit", so the
            # sort-join's bill shows without the kernel's
            tla = torch.abs(join.pairs[6])
            outs = (tla, torch.full_like(tla, -1, dtype=torch.int32), torch.zeros_like(tla), torch.zeros_like(tla),
                    (tla > 0.0).to(torch.int32))
        else:
            outs = mt_chunks(join.block_cluster, cs_set.super_geom, cs_set.super_sbox, *join.pairs,
                             any_hit=any_hit)
    STATS["rounds"] += 1
    STATS["pair_slots"] += n * kc
    with span("wave2.select"):
        return _select(cs, cand, join, outs, tl, cursor, any_hit, ftb, remaining, next_t, new_key)


def _masked(a, mask):
    """``a[mask]``: a boolean-mask index, whose ``nonzero`` reads the mask's
    count on the host."""
    with host_sync("wave2.compact_mask"):
        return a[mask]


def _window_trace(cs_set: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kc: int, any_hit: bool, max_iters: int,
                  ftb: bool = False):
    """Round + compacted-continuation loop on one padded window.  ``tm`` may
    be sign-encoded (negative = occlusion query with limit |tm|)."""
    n = ox.shape[0]
    STATS["windows"] += 1
    cursor0 = torch.full((n,), -1, dtype=torch.int32, device=ox.device)
    with span("wave2.round", continuation=0):
        t, tri, u, v, cur, unres = _round(cs_set, ox, oy, oz, dx, dy, dz, tm, cursor0, kc, any_hit, ftb)
    nsub = min(NSUB, n)
    iters = 0
    for _ in range(max_iters):
        STATS["host_syncs"] += 1  # the check below: one host sync per continuation round
        with host_sync("wave2.unresolved"):
            more = bool(unres.any())
        if not more:
            break
        iters += 1
        with span("wave2.compact"):
            # compact up to nsub unresolved rays (ascending index, stable)
            sel = torch.sort((~unres).to(torch.int32), stable=True).indices[:nsub]
            live = unres[sel]
            g = lambda a: a[sel]
            cap = torch.where(live, torch.where(g(tm) < 0.0, -g(t), g(t)), 0.0)
        with span("wave2.round", continuation=iters):
            t_r, tri_r, u_r, v_r, cur_r, unres_r = _round(
                cs_set, g(ox), g(oy), g(oz), g(dx), g(dy), g(dz), cap, g(cur), kc, any_hit, ftb)
        with span("wave2.compact"):
            improved = live & (t_r < g(t))
            on_live = lambda a: _masked(a, live)
            idx = on_live(sel)  # writes for dead lanes are dropped
            upd = lambda a, new: a.index_copy_(0, idx, on_live(torch.where(improved, new, g(a))))
            upd(u, u_r)
            upd(v, v_r)
            upd(tri, tri_r)
            upd(t, t_r)
            cur.index_copy_(0, idx, on_live(cur_r))
            unres.index_copy_(0, idx, on_live(live & unres_r))
    STATS["continuations"] += iters
    STATS["max_window_continuations"] = max(STATS["max_window_continuations"], iters)
    return t, tri, u, v, unres


def _wave2_trace(cs_set: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kc: int, any_hit: bool, max_iters: int,
                 ftb: bool = False):
    """Full-wavefront trace: rays with work are compacted to the front with
    one stable sort and traced in windows of SUBWAVE rays, so the cost
    follows the live ray count down the bounce ladder."""
    with span("wave2.trace", any_hit=any_hit):
        return _windows(cs_set, ox, oy, oz, dx, dy, dz, tm, kc, any_hit, max_iters, ftb)


def _windows(cs_set: ClusterSet, ox, oy, oz, dx, dy, dz, tm, kc: int, any_hit: bool, max_iters: int, ftb: bool):
    n0 = ox.shape[0]
    s = min(SUBWAVE, -(-n0 // CHUNK) * CHUNK)
    n = -(-n0 // s) * s
    padded = lambda x, fill: torch.cat([x, x.new_full((n - n0,), fill)]) if n != n0 else x
    with span("wave2.compact"):
        wanted = padded(tm, 0.0) != 0.0
        _, ridx, cox, coy, coz, cdx, cdy, cdz, ctm = _stable_sort(
            (~wanted).to(torch.int32), _arange(n, ox),
            padded(ox, 0.0), padded(oy, 0.0), padded(oz, 0.0),
            padded(dx, 1.0), padded(dy, 0.0), padded(dz, 0.0), padded(tm, 0.0))
    with host_sync("wave2.live_count"):
        n_sub = -(-int(wanted.sum().item()) // s)  # one host sync per trace
    STATS["host_syncs"] += 1

    t = ctm.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=ox.device)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    ovf = torch.zeros((n,), dtype=torch.bool, device=ox.device)
    for i in range(n_sub):
        w = slice(i * s, (i + 1) * s)
        with span("wave2.window", index=i):
            t[w], tri[w], u[w], v[w], ovf[w] = _window_trace(
                cs_set, cox[w], coy[w], coz[w], cdx[w], cdy[w], cdz[w], ctm[w], kc, any_hit, max_iters, ftb)

    # back to caller order
    with span("wave2.compact"):
        back = lambda a: torch.empty_like(a).index_copy_(0, ridx.long(), a)[:n0]
        return back(t), back(tri), back(u), back(v), back(ovf)


def _rays(origin: Vec3, direction: Vec3, t_max):
    tm = t_max * torch.ones_like(origin.x) if torch.is_tensor(t_max) else torch.full_like(origin.x, t_max)
    return origin.x, origin.y, origin.z, direction.x, direction.y, direction.z, tm


def _ftb_default() -> bool:
    """Front-to-back extraction, off unless ``RT_WAVE2_FTB=1``."""
    return os.environ.get("RT_WAVE2_FTB", "0") == "1"


def _kc_default(ftb: bool) -> int:
    """Candidates per ray per round: ``RT_WAVE2_KC``, else 4 front to back
    and 16 in id order."""
    env = os.environ.get("RT_WAVE2_KC")
    if env:
        return int(env)
    return KC_FTB if ftb else KC


@torch.no_grad()
def wave2_closest_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kc: int = None,
                      max_iters: int = 64, with_attrs: bool = False, ftb: bool = None):
    """Closest hit. Returns (t, tri_id, u, v, overflow) — exact; overflow
    marks rays still unresolved after ``max_iters`` continuation rounds.
    ``with_attrs=True`` also returns the winner's interpolated shading
    frame (``interp_tri_attr``).  ``ftb`` and ``kc`` default to the
    environment's (``_ftb_default``, ``_kc_default``)."""
    ftb = _ftb_default() if ftb is None else ftb
    kc = min(kc or _kc_default(ftb), cs.num_supers)
    t, tri, u, v, overflow = _wave2_trace(cs, *_rays(origin, direction, t_max), kc, False, max_iters, ftb)
    t = torch.where(tri < 0, BIG, t)
    if with_attrs:
        return t, tri, u, v, overflow, interp_tri_attr(cs, tri, u, v)
    return t, tri, u, v, overflow


@torch.no_grad()
def wave2_any_hit(cs: ClusterSet, origin: Vec3, direction: Vec3, t_max, kc: int = None, max_iters: int = 64,
                  ftb: bool = None):
    """Any-hit occlusion query. Returns (occluded, overflow)."""
    ftb = _ftb_default() if ftb is None else ftb
    kc = min(kc or _kc_default(ftb), cs.num_supers)
    _, tri, _, _, overflow = _wave2_trace(cs, *_rays(origin, direction, t_max), kc, True, max_iters, ftb)
    return tri >= 0, overflow


def interp_tri_attr(cs: ClusterSet, tri, u, v):
    """Winner shading frame from the input-order attribute table: one row
    gather + barycentric interpolation.  Returns (nx, ny, nz, tex_u, tex_v,
    material_id_f32); miss lanes (tri < 0) return zeros."""
    if cs.tri_attr is None:
        return None
    a = cs.tri_attr[torch.clamp(tri, 0, cs.tri_attr.shape[0] - 1).long()]  # (N, 16)
    w = 1.0 - u - v
    nx = a[:, 0] * w + a[:, 3] * u + a[:, 6] * v
    ny = a[:, 1] * w + a[:, 4] * u + a[:, 7] * v
    nz = a[:, 2] * w + a[:, 5] * u + a[:, 8] * v
    tu = a[:, 9] * w + a[:, 11] * u + a[:, 13] * v
    tv = a[:, 10] * w + a[:, 12] * u + a[:, 14] * v
    hit = (tri >= 0).to(torch.float32)
    return (nx * hit, ny * hit, nz * hit, tu * hit, tv * hit, a[:, 15] * hit)
