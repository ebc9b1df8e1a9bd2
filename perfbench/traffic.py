"""The general generator of a cell's camera stream.

A traffic mix (`perfbench/traffic/<name>.json`) gives the motion and the
sensor: `frames` (the sequence's length), `orbit_speed` (turns of the
orbit a frame), and `depth_noise`, `depth_dropout`, `exposure_amp`. The
configuration gives the camera and the reader's layout (`stream` in
`perfbench/configs/<name>.json`): `cam` (fx, fy, cx, cy, W, H, and a lens
`distortion` through which the capture is taken), and `layout`, whose
`kind` names an entry of `layouts.LAYOUTS` (`replica`: JPEG colour of
`quality`; `tum`: PNG colour, the stamps and the orphan pair; `scannetpp`:
DSLR JPEG colour of `quality` and nerfstudio's transforms; 16-bit depth at
`depth_scale` in all).

`generate` renders every frame of the scene from the seed on the card
(the frozen `scene.py`), pre-distorts it through the lens when there is
one, and writes it with the layout's writers under `root`, four writer
threads encoding while the next frames render.
"""
from __future__ import annotations

import concurrent.futures
import os
import shutil
import time

import numpy as np

from . import layouts, scene
from .reference import remap_bilinear

WRITERS = 4


def generate(stream: dict, traffic: dict, seed: int, root: str,
             device) -> dict:
    """Write the sequence; returns {"poses": (n, 4, 4) GT c2w, "n": n,
    "seconds": generation time, "bytes": bytes written, "paths": [(colour,
    depth)] of each frame}."""
    t0 = time.perf_counter()
    cam, layout = stream["cam"], stream["layout"]
    lay = layouts.entry(layout)
    dist = cam.get("distortion")
    lens = dist is not None and bool(np.any(np.asarray(dist)))
    if lens and not lay.lens:
        raise ValueError(f"a {layout['kind']!r} layout stores no lens; the "
                         f"stream gives the distortion {dist}")
    if os.path.exists(root):
        shutil.rmtree(root)
    for d in lay.dirs:
        os.makedirs(os.path.join(root, d))
    n = int(traffic["frames"])
    poses = np.stack(scene.orbit_poses(n, float(traffic["orbit_speed"])))
    noise = {k: float(traffic[k]) for k in ("depth_noise", "depth_dropout",
                                            "exposure_amp")}
    paths = [lay.paths(root, i, n, layout) for i in range(n)]
    maps = layouts.predistort_maps(cam, dist) if lens else None

    def write(i, rgb, depth):
        if maps is not None:
            rgb = remap_bilinear(rgb, *maps)
        lay.write_frame(root, i, n, rgb, depth, layout)

    with concurrent.futures.ThreadPoolExecutor(
            WRITERS, thread_name_prefix="perfbench-writer") as pool:
        jobs = []
        for i in range(n):
            rgb, depth = scene.render_frame(i, poses[i], cam, n, seed, noise,
                                            device)
            jobs.append(pool.submit(write, i, rgb, depth))
        for j in jobs:
            j.result()
        lay.finish(root, n, poses, cam, layout)
    # This run's files written back now, in set-up, not during the window.
    written = 0
    for d, _, fs in os.walk(root):
        for f in fs:
            path = os.path.join(d, f)
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            written += os.path.getsize(path)
    return {"poses": poses, "n": n, "paths": paths, "bytes": written,
            "seconds": time.perf_counter() - t0}
