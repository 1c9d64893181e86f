"""A configuration's scene file.  A configuration either is a scene file
in the reference renderer's JSON schema (with the benchmark's own keys
beside the scene's, which the loader ignores) or names a generator,
``benchmark/generators/<generator>.py``, whose ``write(directory)`` writes
the scene's files and returns the scene file's path.  A generator's files
are written once per checkout under ``benchmark/_cache/<config>``."""

from __future__ import annotations

import os
import shutil

from .cells import BENCH, load_module

DONE = "COMPLETE"


def scene_path(config_name: str, config: dict, cache: str = None) -> str:
    if "generator" not in config:
        return os.path.join(BENCH, "configs", config_name + ".json")
    cache = cache or os.path.join(BENCH, "_cache")
    final = os.path.join(cache, config_name)
    if os.path.exists(os.path.join(final, DONE)):
        return os.path.join(final, config["scene_file"])
    partial = final + ".partial"  # a run cut off while writing leaves this
    shutil.rmtree(partial, ignore_errors=True)
    shutil.rmtree(final, ignore_errors=True)
    path = load_module("generators", config["generator"]).write(partial)
    open(os.path.join(partial, DONE), "w").close()
    os.replace(partial, final)
    return os.path.join(final, os.path.basename(path))
