"""Start the ranks of a ``torch.distributed`` group as processes on this
host, and pick their backend.

``run_ranks`` starts one process a rank, each with its output in a log file
of its own, waits for all of them against one deadline, and kills every one
that is left when the deadline passes, so that a rank that hangs in a
rendezvous or a collective never hangs the caller.  ``backend_for`` says
which backend a group of ``n`` ranks on ``device`` takes: NCCL when every
rank has a card of its own, gloo otherwise (ranks on the CPU, or sharing a
card, which NCCL refuses).  The collectives of ``parallel/mesh.py`` never
switch it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def backend_for(n_ranks: int, device) -> str:
    """``"nccl"`` when ``device`` is CUDA and the host has a card for each
    of the ``n_ranks`` ranks, else ``"gloo"``."""
    cuda = torch.device(device).type == "cuda"
    return "nccl" if cuda and torch.cuda.device_count() >= n_ranks else "gloo"


def rank_device(rank: int, device) -> str:
    """The device of rank ``rank``: card ``rank`` modulo the host's cards
    for a CUDA ``device``, else the CPU."""
    if torch.device(device).type == "cuda":
        return f"cuda:{rank % torch.cuda.device_count()}"
    return "cpu"


def run_ranks(argv_of_rank, world: int, log_dir: str, timeout_s: float, env=None):
    """Run ``argv_of_rank(rank)`` for every rank of ``world``, all at once,
    from the repository root with it on ``PYTHONPATH``; the output of rank
    r goes to ``log_dir/rank<r>.log``.  Returns [(exit code or None where the
    deadline killed it, its log's text)] in rank order."""
    os.makedirs(log_dir, exist_ok=True)
    env = dict(os.environ if env is None else env, PYTHONPATH=ROOT)
    paths = [os.path.join(log_dir, f"rank{rank}.log") for rank in range(world)]
    deadline = time.monotonic() + timeout_s
    procs = []
    try:
        for rank, path in enumerate(paths):
            with open(path, "w") as out:
                procs.append(subprocess.Popen([sys.executable, *argv_of_rank(rank)], cwd=ROOT, env=env,
                                              stdout=out, stderr=subprocess.STDOUT))
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for path in paths:
        with open(path) as f:
            texts.append(f.read())
    return list(zip(codes, texts))
