"""Render-state checkpoint / resume (port of ``raytracer_tpu/render/checkpoint.py``).

Pass-based accumulation is resumable: the whole render state is the film
(sum, secondary sum, passes finished) and the sampler seed, and every
sample is keyed by (pixel, pass, dim, seed), so reloading the film and
rendering on continues bit for bit.  The file is the reference's ``.npz``
format version 1 (the pass counters as 0-d int32 arrays, the metadata as a
JSON string), so a checkpoint written by either package resumes in the
other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .film import Film

_FORMAT_VERSION = 1


def save_checkpoint(path: str, film: Film, seed: int, extra: dict | None = None) -> None:
    """Write render state to ``path`` (.npz).  Atomic: written beside it,
    then renamed over it."""
    meta = {"version": _FORMAT_VERSION, "seed": int(seed)}
    if extra:
        meta.update(extra)
    tmp = path + ".tmp"
    if not tmp.endswith(".npz"):
        tmp += ".npz"  # np.savez appends .npz to a name without it
    np.savez_compressed(
        tmp,
        sum=film.sum.detach().cpu().numpy(),
        secondary_sum=film.secondary_sum.detach().cpu().numpy(),
        num_passes=np.asarray(film.num_passes, np.int32),
        num_secondary_passes=np.asarray(film.num_secondary_passes, np.int32),
        meta=json.dumps(meta),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str, device) -> tuple[Film, int, dict]:
    """Read render state onto ``device``: returns (film, seed, meta)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version: {meta.get('version')}")
        film = Film(
            sum=torch.as_tensor(z["sum"], device=device),
            secondary_sum=torch.as_tensor(z["secondary_sum"], device=device),
            num_passes=int(z["num_passes"]),
            num_secondary_passes=int(z["num_secondary_passes"]),
        )
    return film, int(meta["seed"]), meta
