"""The needed work of one ray cast of a batch of frames: every pixel's ray
against the geoms its tile can see, and the nearest hit's normal.

Copied from the repository's chip_smoke.py at commit
c4951def7b192ba06c207f9c1c9298bddc6ddcb8 (``RAY_OPS`` and phase 10's
``cost``). Operations: one ray against one visible geom of each branch
(its frame change and the z-buffer compare included): plane 23, sphere 47,
box 58, capsule 121, cylinder 66; a hull 19 and 27 per real face; the
winner's hit point, unit normal and world normal 31 per pixel. The rays a
geom meets are those of the tiles whose view frustum its bounding sphere
crosses, which the data decide: they are counted with the plain
reference's per-tile cull (``reference/render/raycast.tile_survivors_plain``)
on the frames' own poses. Bytes: the frames' geom tables, the scene's
code and hull face tables, the rays and tile planes read once; depth,
geom id and normal written once per pixel.
"""

from __future__ import annotations

import torch

RAY_OPS = (23, 47, 58, 121, 66)
RAY_OPS_HULL, RAY_OPS_FACE, RAY_OPS_PIXEL = 19, 27, 31


def cast_work(par, code, faces, dirs, cull, width: int, height: int,
              tile: int, frames: int) -> tuple:
    """(operations, bytes) of casting ``frames`` frames, the operations
    from the sample of frames whose geom tables ``par`` holds (scaled to
    ``frames``), with the tables of ``reference.render.raycast``."""
    from benchmark.reference.render.raycast import tile_survivors_plain
    keep = tile_survivors_plain(par, code, cull)           # (b, T, G)
    T = keep.shape[1]
    tx_n = -(-width // tile)
    npix = torch.tensor([(min(height, (k // tx_n + 1) * tile)
                          - k // tx_n * tile)
                         * (min(width, (k % tx_n + 1) * tile)
                            - k % tx_n * tile) for k in range(T)],
                        dtype=torch.float64)
    nface = (faces[:, :, 3] < 1e9).sum(-1).tolist()
    per = torch.tensor([0 if c < 0 else RAY_OPS[c] if c < 5
                        else RAY_OPS_HULL + RAY_OPS_FACE * nface[r]
                        for c, r in code.tolist()], dtype=torch.float64)
    N = dirs.shape[0]
    sample = keep.shape[0]
    culled = float(((keep.double() * per).sum(-1) @ npix).sum())
    ops = culled * frames / sample + frames * N * RAY_OPS_PIXEL
    G = code.shape[0]
    nbytes = (frames * G * 16 * 4 + code.numel() * 4 + faces.numel() * 4
              + N * 12 + T * 16 * 4 + G * 4 + frames * N * 20)
    return ops, nbytes
