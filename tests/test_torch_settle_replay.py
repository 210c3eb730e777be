"""A fast-spinning object of the port's settled pile, replayed through the
JAX package's contact step.

``python3 chip_smoke.py --dump-settle PATH`` wrote the settle roll's
fastest scenarios (one NVIDIA H100 80GB HBM3 at 700 W: B=4096, 300 steps at
ncon=128, iterations=30 from the seeded drop). Split into linear and
angular speed, no object there moves faster than 2.70 m/s (the fastest
are falling freely, gaining 9.8 m/s per second), while spins reach 25.9
rad/s. Scenario 3732 ends
with an object spinning at 22.6006 rad/s, from 7.94 rad/s 50 steps earlier.
Its state at step 250 (qpos, qvel and the warm start, 43 nonzero
candidate rows) is embedded below, from that dump.

Replayed for 50 steps (ncon=128, iterations=30) by the JAX package's
``step_warm`` (jit, vmap) and by the port's on the CPU, on identical
compiled arrays (``model_from_arrays``), the spin grows alike in both: the
objects' largest angular speed after every step agrees within 1e-3 rad/s,
the largest linear speed within 1e-4 m/s, and after the 50th step both
equal the card's 22.6006 rad/s within 1e-3 relative (on an 8-core CPU:
5.9e-5 rad/s and 8.3e-7 m/s at most; the port's last spin equals the
card's to the bit, JAX's is 2.5e-7 from it). So the fast spins of the
settled pile are the reference algorithm's behaviour, not the port's.
"""

import base64
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_rl_ur5_tpu.physics import dynamics as jdyn
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu.scene.model import State as JState
from mujoco_rl_ur5_tpu_torch import PILE
from mujoco_rl_ur5_tpu_torch.carry import model_from_arrays
from mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS, State

STEPS, CARD_SPIN = 50, 22.600616455078125     # the card's largest spin after them
# float32: qpos (nq), qvel (nv), scalar-row warm forces (S), the nonzero
# candidate rows of the facet warm forces, their (ncand-row) values
STATE = (
    "eNqNlglUjdv7x0+F5oFQaKI0qY4mDWfvZx8J5aZoECE0yVBXSqJ7G5SUKSWZ04CiDKVSznnf"
    "fahIqFCm3ChdUzLcSoZ0/8f5rWX91v/3c9dvr/VZe7/P8+zn+e797v2u13ffFnbCpD+Iqtws"
    "uiHdg3rUp6OFEVZUZ+Z0pHVPCS3TP8vwqCUdnxlIVlTFEr8ALEg3d2DfvC4RIocj+FCKCpXR"
    "jyC+0cC2Ty9jgyasoTv5HajWfqGQbyxNPccvJ3lfvMFinRl9Ib+Upb1mNCZbnuW7K9LefSHE"
    "cNEucFqiQxsGOoTGXETvTVuFTwUp0OcNAaRF9STMVYnHF+XN4N3VMBL40h6vfqdIn/0ST/Yp"
    "NGPN+X7ELyKEyVooTbQFNbjZUJd+Gr6C9EXGE/35HUIfx5kooCKMia+swumvbKlcXyBZm5qC"
    "wxq2wcz8M2zJ+hCi4X0Ha7+ZSvsHVpMZKp/YHXuPMybGnlSXu499M66M4WYo0ufBweSD5yJh"
    "cwyXzOt0IBErfJnIs9+EVRaIpuI4ck/eli14FsXK/S5NvYvdqeELWdDewaEXvEKJZqYscTa/"
    "BKbFJ9jOB5ZkkNuLa5ps6dldv5Kr053Iaq9Utnaolm0eeAGOxwfxsZS37MbMIHK2q5TtGXoP"
    "71dZQUftHHpkuRT4njalVdmBpNhdD5CiBxUESVPdjjg2JEKRXVLdy07pXEnaeIbk3BAfQl3m"
    "MRtNxPo6jzMqeVpU4VAQySkLh6XBPLZ8lRe5UtDP+qQNg2kZvWzeYDhRyTUjTUVvYXikFF1V"
    "msaWvejHxmkTaVHir2T/DAMaMfsOCH5Xo/ZsPhtnJgOPIh2o45xNpCBrJjlseYFd8Zs2+1Rd"
    "mjbl5TPKhdL0ocJaIrviCzvSqQ1r8KWgDBaTsGOmODOMSzO8VxO5s3NZjc2rCH/mEkZPugL2"
    "gwNTHO1AD26OIgEO1tTlS6wgdZUOyV9TCfuPPWT+iBhN9+QuJw5j4tiSyfOZnnQb2ve7CQnd"
    "2suYmdlRdbm1JLy0B5/+04Lqr7wLWW4apCuXAxfxSPpasI4skSXEI2A06ZWei0RbC6EIDjnq"
    "LOhnTylGku4VS7EopQ0WeqjTPpElWd8ozdr/Zk9THTYRg64ZxPCWAqP6fD5YDk0gRWkWTObp"
    "abQxOZQ0ubjS3kOKJCzaBIRxUXAuf0BQskebRs4NJK2q8bTq0ViBi99OzAubz3TH6Qj+LhxH"
    "jas3ku0VS8jIssXM5z9OgMzuOuhL78ORV8dSF7NVJLdLlyi9zwSrQV3qGs+w8/Rq8Ix2KWoS"
    "FkB8S7iwYf15bHjFmgZv5dIb4/KFIyfo0rKhcOLql8I8LM9m2yxMSeGABSnafplREH5jrbKW"
    "k3Fu+3CDaQozx8aGBGjY0LxrpULrd19YC4PVpGedPuHdt6VtllxGyyQbRptb8owSrWlYeBDR"
    "44/Des/vw8uOuzh2VQg13lPNvNpnSJ8cXEM0ZcNIuvNmSOwXMC63d4BRthnbHCNLB7LSyNYk"
    "O1IzJEMWqD6DIU9tMM6tZ+bGTqWzyhKJfYEPidRXYzd8HA5zLIdRsxtV0Fq6iX9Nq1Zk6KLG"
    "b7jxkhyouSLyX7sWbT5nLhz26hWqWJmE/FAxSux2ot7LXjGf9/KYQYNjjMfoX8HuvA/tV2qr"
    "dDV7flGmOcmGy/VCVoXZQt3hOqiypQupVITxTG4cIi3dXx2OuTJoY3coTdg83KzdI4obvbWU"
    "u3u/KsNtMkXjXldjLW9/ypU/Qh4EdrCtTDg72FgMF1bL0NS1wdUl6vbVN73Kq00YSyZ7sRfz"
    "SjODWaSkzH977i4NqLkIjT6FTOiSScznLDOmxHi7KGVMOT/q8HKyatYGdvUrXexnuB95nZxL"
    "yqRK+KaqOXwLIx+4vUMJHD4eZINcZFDWs1pBcl7SpaMxEY5FnSfQKCmhcPknBSgQHBOGjLTD"
    "rgWjQMe8lJF+i5lpv/WzJ58NMrs/FrCevTLslMPRzOeGMEam8gl/3owXIKM+T7T+VINwvEKX"
    "oJbI4+Arj9inWgUQO/0u8/eHeuGCvxtRqPJRoeaR/azdTQ/WO5ygqnXNwpCN2ZBVtYmOT6wT"
    "GW7ki9rD4vmNFgx6tVsRYjGfqW13IJy0C1jzqDc12JAszN/UzzzT+cK4pXdXL1LYfumDrZ5j"
    "8PyXTJP1TrbN24s2f8gkU3yTRQZ7VPh7tjsLbddMYn33vxf2ud4nNxcri5KROv+5vh4e/uiO"
    "MEYrS1g4kEw/f1Qio+0tIGf3G2gZsQeCw7Xok4WfKP9tnOivF7r8MYnXmNPSl5mW31agqSoT"
    "2aSuI9AepQ3oQ5hj5ewEQWTSUUFU10i2jvXHPpYMAoO7ggLu2Usjlt9DG/EVcC6+LPzY3UUj"
    "n8vCNw2A0Z6vme0xznSKjRBee0dSk8cvsKLXN+Gx83zG7ak1jXvuTm8NCij3RD1zLvqisHzr"
    "LuHyX8YKY2PvQ19aCTuxMIXJeZjD5HfoMwlfruJZYSJ2063rtLU+GykYNvAONukIhyYqsC2t"
    "o0nQhYU86ZgU3HNuEL2sH8HYWD/C5Y4yhM0vZlR8bwlzBmuxRYsfo5iuRG1iytiOPy+S8Q1F"
    "QrXresKYuOOXREsT2ejqKOEcZycadmsYfvZhDOLtcBPkOhmwWwxzGMe9PZhpsUMT0uV5alMs"
    "eB/UWaSnttXhmtCQapVYYa32ycy1+AfoZoYFefaogg3M5ZIhFWPwTKzHwVMZJjJzD3lS906k"
    "Ly3FH1Zvzjx5pAlSTbeY92p/oKTiKsHJ7S68jfxq1qNQm70x8Ih9ed+g7LaCqRVjs8Ayc0Qt"
    "I6Pqi1vUU5m88YjWuz+lV06r0cc7ZBw5CVtmcDjbZnASvrNDzFEx0s4cjqwzR6ThzOGDGCKG"
    "L7bNduYkuIrtYhLmiJ/dxfiLfWI468TEiMdiOElicpw5emI4+eJeDF/McjGc42JOiikUUyTm"
    "lNgvhi+GUyymRMwZsU0MXwznnJgL4mcx4lbsN4P3vRfOQsD5SVtslA12kAxPzsXCW/5dTN0T"
    "IW5uCoSYboFx31LhhtcOePUgAdSP7YJld0dg81BrcHSzBY1pjvDYdQZsX+oAaX6uwM3/Bc6O"
    "sAOBvCY5LxcLqV/fwPrifpjjPo8cKvQnCm/8yeSDC0ic6TIitWgBGXuYT1KbH8ET+zTyXUds"
    "Ape866yAvxZJEWI9jMgzX8H/oiz5d60Xax6Qn63DXXs3rvn8jdd6RQ0q48/gEWWWuGcWi+WF"
    "4n+mDwF4ZsIh3LEkHY89YC7JIbf57I89WduT+x95R0Wl4xVrj4Pnn2dJTuglPLN+H9yuuAOl"
    "zia8g/rlvIy4KF5zYyqvPESbeNk2YcXyjz/yjR97CWSdE/HyZetwhnIMjmrdjOPuyJMzWtMk"
    "dTpSssjH0xt5Uh3DeF0piLd0yIX3xgjzWpa68J5OuPLTNf57CymwkcS9T/3X/ol6P+GVar8Q"
    "fl8vzO7vgda892Ax/QN82vvuh64GB19J7Mu2FVCSmofejH2Pru0/gpxO9aHv9pvtD4lg4wSi"
    "nGkOj3W9SIhsJGxYqUjKd6oSTy1lEtiqTMwiOeCsMhXk/jyPQ7fMAm1VF1A6fQ0vamnCK80n"
    "g+NYGfARaUEKGkQXcDI2sS1BdpfuocGibCRsWYpcWoNRsHIi+sJLQ7vqfFC2720cOFqLl5qo"
    "gg/9pevoH5OErosOIYHsPvT1bQaazduLFgj2SvTVpCyWrOV0zjTY/DkTWW0DXriLIZryyBZN"
    "Yh3RUNREFD15CwzUFOMhJz9ccfEbepe83jFmMEsyf13jYaQ/4j6vSx8hW9PzvM7FfIhXu4zu"
    "T7LH48ussNOeeKyjbotbKpPwplgfPPA1BK/XLISOfCvwM27HVUpGkvqrKqX5pO0jMhXl4idD"
    "y/DI2iVYNPwhjvh0GnaqJ2GDjATonOUJn2NC4SoKhIY9AfC4cRl0y4TA1DsH4Hxmj/0xOZ4k"
    "l5KdCJcvbMc17jU4YtkN7Ndfj7cJ6/AC3AUVbSpQMJzFDnHKYO+vBp8dRkH2+zGQd1cF8jeP"
    "AQcnVfj4svDH+x0degqfT/HE/+286OwuxRrPFSCcdxxe257BclYpED3dFfb7RcBgXSjsnbce"
    "Qh+ulOR66GaBqzqlJeMvRisl+eS2DsNGgxfRzMxhWItXJdlP5RA1PrzkSM4UPihDdl6ug6CJ"
    "b+C6WTeoZHRDtKBbkmOcgRJpDFrI/z7u7PgiscVvv4P+v8bOwzoS33V3G/ins5869193bdQ7"
    "E0mv7HYE/bc4VyMPibZtBSn/eKdkW56i/+XOOZVkSOpF87Uk+cLv1f3jvLC6Qvwz369jSn+s"
    "8cCoS0TbvAKrp5zhKQY2onY8G/t/3I885gdI5hdl3Zd8x7u6v/60nl7HCWQlN0kSL7OmAsO0"
    "IHw0ZypeG+SNqzPdcJGRJ6bX3PEB31aeRb0htg83d3hsuxU72+/C1zhBOGwwGQe5b8ElK7fi"
    "tJeJWDaXwduKOHBSMwvJV8hJtN410wdPt2bkc7lSoqMhYDb+bYkLL2mHMjxcrSeJ+R2xOHmW"
    "Nbyw04C2aHWQOqoCyWpaEp9/bCY6w9PA/7Rn/wdDNx0P")


def _state(t, ncand):
    a = np.frombuffer(zlib.decompress(base64.b64decode("".join(STATE))),
                      np.float32).copy()
    S = t.neq + 2 * t.nlimit
    qpos, qvel = a[: t.nq], a[t.nq: t.nq + t.nv]
    rest = a[t.nq + t.nv:]
    warm_s, rest = rest[:S], rest[S:]
    nrow = len(rest) // (1 + constraints.NFACET)
    rows = rest[:nrow].astype(np.int64)
    warm_f = np.zeros((ncand, constraints.NFACET), np.float32)
    warm_f[rows] = rest[nrow:].reshape(nrow, constraints.NFACET)
    return qpos[None], qvel[None], warm_f[None], warm_s[None]


def _speeds(qvel):
    v = np.asarray(qvel)[0, 8:].reshape(40, 6)
    return (np.linalg.norm(v[:, :3], axis=-1).max(),
            np.linalg.norm(v[:, 3:], axis=-1).max())


def test_fast_spin_replays_alike_in_jax():
    jm = jax_compile_spec(jax_parse_mjcf(PILE))
    m = model_from_arrays(compile_file(PILE).topo,
                          {n: np.asarray(getattr(jm, n))
                           for n in ARRAY_FIELDS})
    t = m.topo
    qpos, qvel, warm_f, warm_s = _state(t, constraints.n_candidates(m))
    ctrl = np.zeros((1, t.nu), np.float32)
    s = State(torch.from_numpy(qpos), torch.from_numpy(qvel),
              torch.from_numpy(ctrl), torch.zeros(1))
    w = (torch.from_numpy(warm_f), torch.from_numpy(warm_s))
    js = JState(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl),
                jnp.zeros(1))
    jw = (jnp.asarray(warm_f), jnp.asarray(warm_s))
    jstep = jax.jit(jax.vmap(lambda st, ww: jdyn.step_warm(jm, st, ww, 128,
                                                           30)))
    start = _speeds(qvel)[1]
    for _ in range(STEPS):
        s, w = dynamics.step_warm(m, s, w, 128, 30)
        js, jw = jstep(js, jw)
        (lin, ang), (jlin, jang) = _speeds(s.qvel.numpy()), _speeds(js.qvel)
        assert abs(lin - jlin) <= 1e-4 and abs(ang - jang) <= 1e-3
    assert start < 10.0 < ang
    assert abs(ang - CARD_SPIN) <= 1e-3 * CARD_SPIN
    assert abs(jang - CARD_SPIN) <= 1e-3 * CARD_SPIN
