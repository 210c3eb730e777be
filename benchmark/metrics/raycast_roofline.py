"""raycast_roofline: the least time the card needs for the ray casts of
the traced stretch (``counts/raycast.py``: the tables read once, the
outputs written once, the rays that the per-tile cull lets meet each
geom, counted for each call's own batch of the pool) over the device time
of the kernels that did them.

Attribution: the device time, in the traced stretch, of every kernel that
the program's own CUDA sources (``csrc/``) declare; the observation
launches no other kernel of the program. The FK and the render entry's
torch operations show in render.epilogue_ms and device_idle_pct.render."""

import os

import torch

from benchmark.manifest import scene
from benchmark.counts import raycast as counts
from benchmark.device import bound_s, kernel_name, own_kernels

SAMPLE = 64        # frames of a batch whose cull is counted, scaled to it


def read(run):
    import mujoco_rl_ur5_tpu_torch as port
    ours = own_kernels(os.path.dirname(port.__file__))
    t = sum(run.trace.time_by_name(lambda n: kernel_name(n) in ours)
            .values())
    if not t:
        return None
    w = run.work
    pool = len(w.drops_np)
    units = range(run.first, run.first + run.units)
    per = {p: bound_s(*own_count(w, p, w.tr["batch"]))
           for p in {i % pool for i in units}}
    return 100.0 * sum(per[i % pool] for i in units) / t


def own_count(w, p: int, frames: int):
    """The count from the reference's own scene, camera and tables on the
    first SAMPLE frames of the pool's batch ``p``."""
    from benchmark.reference.physics.kinematics import fk
    from benchmark.reference.render import camera, raycast
    from benchmark.reference.scene.compile import load_model
    cfg = w.cfg
    m = load_model(scene(cfg, w.bench), device="cpu")
    cam = camera.make_camera(m, cfg["camera"], cfg["width"], cfg["height"])
    q = torch.from_numpy(w.drops_np[p, :SAMPLE])
    par, code, faces = raycast.geom_table(m, fk(m, q), cam)
    cull = raycast.render_tables(m, cam).cull
    return counts.cast_work(par, code, faces, cam.dirs, cull, cfg["width"],
                            cfg["height"], raycast.TILE, frames)
