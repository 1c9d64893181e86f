"""One run of one cell: set-up, the measured window, the traced reading
(``--trace 1``), and the comparison with the reference."""

from __future__ import annotations

import gc
import json
import subprocess
import time

import torch

from . import cells, check, loops, scenes, tracing


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def rooflines(profile: dict, mods: dict) -> dict:
    """Each kernel's least time over its kept launches, its device time in
    the same units, and the bound that sets it."""
    out = {}
    for kernel, mod in mods.items():
        least, bounds, ops, nbytes = 0.0, {}, 0.0, 0.0
        for a, k in profile["calls"][kernel]:
            o, b = mod.count(a, k)
            t, which = mod.least_seconds(o, b)
            least += t
            ops += o
            nbytes += b
            bounds[which] = bounds.get(which, 0.0) + t
        kernel_s = sum((e - s) * 1e-9 for name, s, e, _ in profile["ops"] if mod.KERNEL in name)
        out[kernel] = {"launches": len(profile["calls"][kernel]), "least_s": least, "kernel_s": kernel_s,
                       "ops": ops, "bytes": nbytes,
                       "bound": max(bounds, key=bounds.get) if bounds else None}
        profile["calls"][kernel] = []  # the kept inputs go
    return out


def result_lines(result: dict) -> tuple[list, str]:
    """(the last lines of standard error, the last line of standard
    output): the verdict, then each number compared beside its limit; the
    result as one JSON object whose last key is ``checks``."""
    err = [f"correct: {result['correct']}"]
    err += [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in result["checks"].items()]
    line = {k: v for k, v in result.items() if k != "checks"}
    line["checks"] = result["checks"]
    return err, json.dumps(line)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log) -> dict:
    dev = torch.device(device)
    scene_file = scenes.scene_path(cell.config_name, cell.config)
    loop = loops.make(cell, scene_file, seed, dev)
    loop.setup()
    loops.sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    w = loop.window(seconds)
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"window: {w['units']} {loop.unit}s in {w['wall_s']:.3f} s, failed {w['failed']}, {w['metrics']}")
    result = {"attempted": w["attempted"], "failed": w["failed"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = loop.outputs()
    if not trace:
        values = dict(w["metrics"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    else:
        units = int(cell.traffic["trace_units"])
        mods = cells.rooflines()
        profile = tracing.profile_units(loop.step, units, cells.spans(), mods, dev)
        log(f"profiled {units} {loop.unit}s: wall {profile['wall_s']:.3f} s, device busy {profile['busy_s']:.4f} s, "
            f"{profile['n_ops']} device ops ({profile['unlinked_ops']} without a launch event), layers "
            f"{ {k: round(v, 6) for k, v in profile['layers_s'].items()} }")
        ctx = {"loop": cell.traffic["loop"], "window": w, "profile": profile, "rooflines": rooflines(profile, mods)}
        for kernel, r in ctx["rooflines"].items():
            log(f"roofline {kernel}: {r['launches']} launches, least {r['least_s'] * 1e3:.4f} ms "
                f"({r['bound']}), device {r['kernel_s'] * 1e3:.4f} ms; card {power_limit()}")
        ctx.update(loop.traced())
        metrics = {}
        for m in cell.per_layer:
            v = cells.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        device_info.update(busy_s=profile["busy_s"], window_s=profile["wall_s"])
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
        del profile, ctx
    result["device"] = device_info
    loop.free()
    del loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    found = check.numbers(cell, scene_file, out, seed, dev)
    log(f"reference comparison {time.perf_counter() - t0:.3f} s: {found}")
    correct, shown = check.judge(found, cell.limits)
    result["correct"] = correct
    result["checks"] = shown
    return result
