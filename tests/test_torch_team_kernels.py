"""The kernels redesigned for Hopper, checked on the host.

* ``lqr_backward`` (a team of 16 lanes per scenario), ``rollout_closed``
  (the alphas of 32 scenarios in one block), ``lin_fd`` (24 threads per
  (scenario, knot) and the composition in shared memory), ``ee_quad_gn``
  (the full stage blocks X and g, each warp's span written through shared
  memory) and the ray cast (a block per 16 x 16 tile, its geoms culled)
  compile with g++ through the threaded host shim of
  tests/test_torch_host_shim.py, which runs every CUDA thread of a block
  as a host thread. Called through their C entry points on CPU tensors at
  ragged sizes (11 scenarios for blocks of 8, 37 for blocks of 32, 15
  instances for blocks of 4, 111 and 185 instances for blocks of 128 with
  a part-filled and an empty warp, tiles of 16 x 8 pixels at the image's
  edge), the chain kernels are held as
  chip_smoke.py's phase 3 holds them on the card: against the plain
  version run in float64, each output's error at most twice the plain
  float32 version's plus 1e-6 of its scale (the host's sinf/cosf and
  1/sqrt stand in for the card's). ``rollout_closed`` runs with the
  solver's 5 alphas and with the 8 its launch takes at most (a block of
  256 threads); ``lin_fd`` with the composition over 8 substeps, over 1
  (none), and as the full-knot differences over 2 substeps; ``ee_quad_gn``
  from the solver's strided view of its states, its zeros and velocity
  diagonal exact. The ray cast
  equals the plain cast to the bit (both round every operation alike and
  take correctly rounded roots: the plain version in float64, the host's
  sqrtf exactly) and its survivor lists equal the plain cull's.
* The wrappers' input checks raise on what the kernels do not take,
  before any launch.
"""

import numpy as np
import pytest
import torch
from test_torch_host_shim import host_build

from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import EE_OFFSET, GraspMPC
from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc

HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])
ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03)
ALPHAS8 = (1.0, 0.8, 0.6, 0.45, 0.3, 0.2, 0.1, 0.03)

def _hold(outs, plain32, plain64):
    """chip_smoke.py's phase 3 rule, output by output."""
    for k, p, r in zip(outs, plain32, plain64):
        assert bool(torch.isfinite(k).all())
        scale = float(r.abs().max())
        ek = float((k.double() - r).abs().max()) / scale
        ep = float((p.double() - r).abs().max()) / scale
        assert ek <= 2 * ep + 1e-6, (ek, ep)


@pytest.fixture(scope="module")
def mpc():
    return GraspMPC.from_scene(ASSET, horizon=3, substeps=2, iters=1,
                               device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _riccati_problem(B, H, seed=1):
    rng = np.random.default_rng(seed)

    def spd(shape, n, scale=1.0, floor=0.1):
        W = rng.standard_normal(shape + (n, n))
        return scale * W @ np.swapaxes(W, -1, -2) / n + floor * np.eye(n)

    return (_t(np.eye(16) + 0.1 * rng.standard_normal((B, H, 16, 16))),
            _t(0.1 * rng.standard_normal((B, H, 16, 7))),
            _t(spd((B, H), 16, floor=1.0)), _t(rng.standard_normal((B, H, 16))),
            _t(spd((B, H), 7, 0.1, 1e-3)), _t(rng.standard_normal((B, H, 7))),
            _t(spd((B,), 16, floor=1.0)), _t(rng.standard_normal((B, 16))),
            _t(10.0 ** rng.uniform(-6, 1, B)))


def test_riccati_kernel_source_runs_on_the_host(tmp_path):
    fn = host_build(cuda_lqr.SOURCE, tmp_path)
    B, H = 11, 5                       # one full block of 8 and a ragged one
    ins = _riccati_problem(B, H)
    assert cuda_lqr.check_inputs(*ins) == (B, H)
    outs = (torch.empty(B, H, 7, 16), torch.empty(B, H, 7),
            torch.empty(B, H + 1, 16, 16), torch.empty(B, H + 1, 16))
    assert fn(*[t.data_ptr() for t in ins + outs], B, H, 16, 7, None) == 0
    _hold(outs, cuda_lqr.backward_plain(*ins),
          cuda_lqr.backward_plain(*[t.double() for t in ins]))
    assert torch.equal(outs[2], outs[2].transpose(-1, -2))   # S symmetric


def _closed_problem(mpc, B, seed=0):
    rng = np.random.default_rng(seed)
    H, S = mpc.H, mpc.substeps
    x0 = _t(np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                            0.1 * rng.standard_normal((B, 8))], -1))
    us = _t(0.1 * rng.standard_normal((B, H, 7)))
    xbar = cc.rollout_open_plain(mpc.plan, S, x0, us).contiguous()
    K = _t(0.05 * rng.standard_normal((B, H, 7, 16)))
    d = _t(0.1 * rng.standard_normal((B, H, 7)))
    sref = _t(np.concatenate([xbar[:, :-1, :8].numpy()
                              + 0.05 * rng.standard_normal((B, H, 8)),
                              np.zeros((B, H, 8))], -1))
    tref = _t(np.concatenate([xbar[:, -1, :8].numpy(), np.zeros((B, 8))], -1))
    targets = _t(np.array([0.0, -0.6, 1.0])
                 + 0.1 * rng.uniform(-1, 1, (B, 3)))
    return (x0, xbar, us, K, d), {"track": (sref, tref),
                                  "reach": (None, targets)}


@pytest.fixture(scope="module")
def closed_kernel(mpc, tmp_path_factory):
    """The host build of rollout_closed for each fused cost pair, made once
    for the module."""
    built = {}

    def get(mode, R, RT):
        if mode not in built:
            cost = mpc._k_track if mode == "track" else mpc._k_reach
            src = cc._closed_src(mpc.plan, cost, R, RT)
            built[mode] = host_build(src, tmp_path_factory.mktemp(mode))
        return built[mode]
    return get


@pytest.mark.parametrize("alphas", [ALPHAS, ALPHAS8], ids=["A5", "A8"])
@pytest.mark.parametrize("mode", ["track", "reach"])
def test_rollout_closed_kernel_source_runs_on_the_host(mpc, closed_kernel,
                                                        mode, alphas):
    B, H, A, S = 37, mpc.H, len(alphas), mpc.substeps   # 32 + a ragged 5
    args, refs = _closed_problem(mpc, B)
    sref, tref = refs[mode]
    cost = mpc._k_track if mode == "track" else mpc._k_reach
    R, RT = 0 if sref is None else sref.shape[-1], tref.shape[-1]
    fn = closed_kernel(mode, R, RT)
    assert cc.check_closed_inputs(mpc.plan, *args, alphas, sref,
                                  tref) == (B, H, A, R, RT)
    outs = (torch.empty(B, A, H + 1, 16), torch.empty(B, A, H, 7),
            torch.empty(B, A))
    ptrs = [0 if t is None else t.data_ptr()
            for t in (*args, sref, tref, *outs)]
    al = list(alphas) + [0.0] * (cc._NALPHA - A)
    assert fn(*al, *ptrs, B, H, A, S, None) == 0
    plain = cc.rollout_closed_plain(mpc.plan, S, *args, alphas, cost, sref,
                                    tref)
    plain64 = cc.rollout_closed_plain(
        mpc.plan, S, *[t.double() for t in args], alphas, cost,
        None if sref is None else sref.double(), tref.double())
    _hold(outs, plain, plain64)


@pytest.fixture(scope="module")
def lin_kernel(mpc, tmp_path_factory):
    return host_build(cc._lin_src(mpc.plan), tmp_path_factory.mktemp("lin"))


@pytest.mark.parametrize("mode, substeps", [("fast", 8), ("fast", 1),
                                            ("full", 2)])
def test_lin_fd_kernel_source_runs_on_the_host(mpc, lin_kernel, mode,
                                               substeps):
    B, H = 5, 3                       # 15 instances: blocks of 4, one ragged
    rng = np.random.default_rng(5)
    x0 = _t(np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                            0.1 * rng.standard_normal((B, 8))], -1))
    us = _t(0.1 * rng.standard_normal((B, H, 7)))
    # the solver's view: the knots of (B, H+1, 16) states, batch-strided
    xs = cc.rollout_open_plain(mpc.plan, 2, x0, us).contiguous()[:, :-1]
    F, L = torch.empty(B, H, 16, 16), torch.empty(B, H, 16, 7)
    fd, rounds = (1, substeps.bit_length() - 1) if mode == "fast" \
        else (substeps, 0)
    assert lin_kernel(xs.data_ptr(), us.data_ptr(), F.data_ptr(),
                      L.data_ptr(), B * H, H, xs.stride(0), fd, rounds,
                      None) == 0
    plain = cc.lin_fd_fast_plain if mode == "fast" else cc.lin_fd_plain
    _hold((F, L), plain(mpc.plan, substeps, xs, us),
          plain(mpc.plan, substeps, xs.double(), us.double()))


@pytest.fixture(scope="module")
def quad_kernel(mpc, tmp_path_factory):
    w = mpc.w
    src = cc.ee_quad_source(mpc.plan, mpc.ee_slot, EE_OFFSET, w.w_ee_run,
                            w.w_orient, w.w_posture, w.w_vel, mpc.home)
    return host_build(src, tmp_path_factory.mktemp("quad"))


def _quad_problem(B, H, seed=3):
    """Knot states as the solver hands them (the first H of (B, H+1, 16),
    batch-strided) and targets (B, 3)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([HOME + 0.3 * rng.standard_normal((B, H + 1, 8)),
                        0.2 * rng.standard_normal((B, H + 1, 8))], -1)
    tg = np.array([0.0, -0.6, 1.0]) + 0.1 * rng.standard_normal((B, 3))
    return _t(x)[:, :-1], _t(tg)


@pytest.mark.parametrize("B, H", [(3, 37), (5, 37)])
def test_ee_quad_gn_kernel_source_runs_on_the_host(mpc, quad_kernel, B, H):
    w = mpc.w
    xs, tg = _quad_problem(B, H)
    assert cc.check_quad_inputs(mpc.plan, xs, tg) == (B, H)
    X = torch.full((B, H, 16, 16), float("nan"))
    g = torch.full((B, H, 16), float("nan"))
    assert quad_kernel(xs.data_ptr(), xs.stride(0), tg.data_ptr(),
                       X.data_ptr(), g.data_ptr(), B * H, H, None) == 0
    cfg = (mpc.plan, mpc.ee_slot, EE_OFFSET, w.w_ee_run, w.w_orient,
           w.w_posture, w.w_vel, mpc.home)
    plain = cc.ee_quad_gn_plain(*cfg, xs, tg)
    _hold((X, g), plain, cc.ee_quad_gn_plain(*cfg, xs.double(), tg.double()))
    # written from constants, exactly: zeros off the blocks, w_vel on the
    # velocity diagonal, and w_vel qd
    vel = torch.zeros(8, 8)
    vel.diagonal()[:] = w.w_vel
    assert not X[..., :8, 8:].any() and not X[..., 8:, :8].any()
    assert torch.equal(X[..., 8:, 8:], vel.expand(B, H, 8, 8))
    assert torch.equal(g[..., 8:], plain[1][..., 8:])
    assert torch.equal(X, X.transpose(-1, -2))


def test_raycast_kernel_source_culls_on_the_host(tmp_path):
    from mujoco_rl_ur5_tpu_torch import OBJECTS
    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
    from mujoco_rl_ur5_tpu_torch.render import cuda_raycast, raycast
    from mujoco_rl_ur5_tpu_torch.render.camera import make_camera
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
    from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_FREE
    fn = host_build(cuda_raycast.SOURCE, tmp_path)
    m = load_model(OBJECTS, device="cpu")
    t = m.topo
    rng = np.random.default_rng(6)
    B, W = 3, 24
    q = np.tile(m.qpos0.numpy().astype(np.float64), (B, 1))
    q[:, :6] = [-1.42, -1.08, 0.348, -1.739, 3.142, 0.671]  # pads over the bin
    for j in np.nonzero(t.jnt_type == JNT_FREE)[0]:
        qa = t.jnt_qposadr[j]
        q[:, qa: qa + 2] += rng.uniform(-0.01, 0.01, (B, 2))
        quat = rng.normal(size=(B, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)
    cam = make_camera(m, "top_down", W, W)
    par, code, faces = raycast.geom_table(
        m, fk(m, torch.from_numpy(q.astype(np.float32))), cam)
    cull = raycast.render_tables(m, cam).cull
    N, G, F, T = W * W, par.shape[1], faces.shape[1], 4
    outs = [torch.empty(B, N), torch.empty(B, N, dtype=torch.int32),
            torch.empty(B, N, 3), torch.zeros(B, T, dtype=torch.int32),
            torch.full((B, T, G), -1, dtype=torch.int32)]
    keep = [par, code.to(torch.int32).contiguous(), faces, cam.dirs,
            cull.planes, cull.radius, *outs]
    assert fn(*(x.data_ptr() for x in keep), B, W, W, G, F, cull.nhull,
              None) == 0
    want = cuda_raycast.cast_rays(par, code, faces, cam.dirs, cull,
                                  survivors=True)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    wins = code[want[1].long(), 0][want[0] < 1e9]
    assert set(wins.tolist()) == set(range(6))             # every branch
    count = outs[3]
    assert int(count.min()) >= 1 and int(count.max()) < G   # some culled
    assert bool((outs[4][..., 0] == t.geom_id("floor")).all())


def _bad(t, how):
    """A wrong version of a good input: another dtype, strides, shape or
    alignment."""
    if how == "float64":
        return t.double()
    if how == "strided":
        return torch.stack([t, t], -1)[..., 0]
    if how == "shape":                         # one scenario short
        return t[:-1].contiguous()
    flat = torch.empty(t.numel() + 1)          # 4 bytes off 16-byte alignment
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


_HOWS = ("float64", "strided", "shape")


# F L X q U r XH qH reg; the kernel reads F, L, X, q and XH by 16 bytes
@pytest.mark.parametrize("which, how", [(w, h) for w in range(9)
                                        for h in _HOWS]
                         + [(w, "unaligned") for w in (0, 1, 2, 3, 6)])
def test_backward_input_check_raises(which, how):
    ins = list(_riccati_problem(2, 3))
    ins[which] = _bad(ins[which], how)
    with pytest.raises(ValueError, match="backward"):
        cuda_lqr.check_inputs(*ins)


def test_backward_input_check_takes_only_its_widths():
    F, L, X, q, U, r, XH, qH, reg = _riccati_problem(2, 3)
    with pytest.raises(ValueError, match="nu=7"):
        cuda_lqr.check_inputs(F, L[..., :6].contiguous(), X, q,
                              U[..., :6, :6].contiguous(), r[..., :6]
                              .contiguous(), XH, qH, reg)


# the kernel reads x0, xbar, K and sref by 16 bytes
@pytest.mark.parametrize("which, how", [
    (w, h) for w in ("x0", "xbar", "ubar", "K", "d", "sref", "tref")
    for h in _HOWS] + [(w, "unaligned") for w in ("x0", "xbar", "K", "sref")])
def test_rollout_closed_input_check_raises(mpc, which, how):
    args, refs = _closed_problem(mpc, 3)
    named = dict(zip(("x0", "xbar", "ubar", "K", "d"), args))
    named["sref"], named["tref"] = refs["track"]
    named[which] = _bad(named[which], how)
    with pytest.raises(ValueError, match="rollout_closed"):
        cc.check_closed_inputs(mpc.plan, *(named[k] for k in (
            "x0", "xbar", "ubar", "K", "d")), ALPHAS, named["sref"],
            named["tref"])


@pytest.mark.parametrize("which, how", [("xs", "strided"), ("xs", "shape"),
                                        ("us", "strided"), ("us", "shape")])
def test_lin_fd_input_check_raises(mpc, which, how):
    """The launch takes xs with any batch stride but rows of 16 contiguous
    knots, us contiguous, both (B, H, ...): anything else raises before a
    build or launch."""
    B, H = 3, mpc.H
    ins = {"xs": torch.zeros(B, H + 1, 16)[:, :-1], "us": torch.zeros(B, H, 7)}
    ins[which] = _bad(ins[which], how)
    with pytest.raises(ValueError, match="lin_fd"):
        cc._lin_launch(mpc.plan, ins["xs"], ins["us"], 1, 1)


@pytest.mark.parametrize("which, how", [
    (w, h) for w in ("xs", "targets") for h in _HOWS] + [("xs", "unaligned")])
def test_ee_quad_gn_input_check_raises(mpc, which, how):
    """The launch reads xs (B, H, 16) with any batch stride but rows of 16
    contiguous floats, 16-byte aligned, and targets (B, 3) contiguous:
    anything else raises before a build or launch."""
    ins = dict(zip(("xs", "targets"), _quad_problem(3, 4)))
    ins[which] = _bad(ins[which], how)
    with pytest.raises(ValueError, match="ee_quad_gn"):
        cc.check_quad_inputs(mpc.plan, ins["xs"], ins["targets"])


def test_rollout_closed_input_check_counts_alphas(mpc):
    args, refs = _closed_problem(mpc, 3)
    cc.check_closed_inputs(mpc.plan, *args, (1.0,) * 8, *refs["track"])
    with pytest.raises(ValueError, match="alphas"):
        cc.check_closed_inputs(mpc.plan, *args, (1.0,) * 9, *refs["track"])
    with pytest.raises(ValueError, match="alphas"):
        cc.check_closed_inputs(mpc.plan, *args, (), *refs["track"])


def test_rollout_open_kernel_source_runs_on_the_host(mpc, tmp_path):
    """The open-loop rollout in the public layout, a team of 8 lanes per
    scenario, against float64 by phase 3's rule at a ragged batch (37: no
    multiple of a block's 16 scenarios)."""
    fn = host_build(cc._open_src(mpc.plan), tmp_path)
    B, H, S = 37, mpc.H, mpc.substeps
    rng = np.random.default_rng(8)
    x0 = _t(np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                            0.3 * rng.standard_normal((B, 8))], -1))
    us = _t(0.5 * rng.standard_normal((B, H, 7)))
    assert cc.check_open_inputs(mpc.plan, x0, us) == (B, H)
    xs = torch.full((B, H + 1, 16), float("nan"))
    assert fn(x0.data_ptr(), us.data_ptr(), xs.data_ptr(), B, H, S,
              None) == 0
    _hold((xs,), (cc.rollout_open_plain(mpc.plan, S, x0, us),),
          (cc.rollout_open_plain(mpc.plan, S, x0.double(), us.double()),))


def _chain_xml(n: int) -> str:
    """A hinge chain of n links (axes z, y, x in turn; a body without a
    joint after link n // 2, which the team plan merges into its parent)
    ending in two fingers coupled by a joint equality; every joint but j1
    actuated (j1's role has no control): nv = n + 2."""
    axes = ("0 0 1", "0 1 0", "1 0 0")
    opened, closed = [], []
    for i in range(n):
        m = 3.0 / (i + 1)
        opened.append(
            f'<body name="l{i}" pos="0 {0.02 * (i % 2)} {0.1 + 0.02 * i}" '
            f'euler="{0.1 * i} 0 {0.2 * i}"><joint name="j{i}" '
            f'axis="{axes[i % 3]}"/><inertial pos="0 0 0.05" mass="{m:g}" '
            f'diaginertia="{0.01 * m:g} {0.012 * m:g} {0.008 * m:g}"/>')
        closed.append("</body>")
        if i == n // 2:
            opened.append('<body name="fixed" pos="0 0 0.05"><inertial '
                          'pos="0.01 0 0" mass="0.3" diaginertia="1e-3 1e-3 '
                          '1e-3"/>')
            closed.append("</body>")
    fingers = "".join(
        f'<body name="f{s}" pos="0.03 {y} 0"><joint name="f{s}" axis="0 0 1"'
        f' damping="0.1" armature="0"/><inertial pos="0.01 0 0" '
        f'mass="0.03" diaginertia="2e-6 1.5e-6 1e-6"/></body>'
        for s, y in (("a", 0.01), ("b", -0.01)))
    motors = "".join(f'<motor joint="j{i}" gear="50" ctrlrange="-1 1"/>'
                     for i in range(n) if i != 1)
    return f"""<mujoco model="chain">
  <compiler angle="radian" inertiafromgeom="false"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <default><joint damping="0.5" armature="0.01"/>
    <motor ctrllimited="true"/></default>
  <worldbody><geom name="floor" type="plane" size="1 1 0.1"/>
    <body name="base" pos="0 0 0.5"><inertial pos="0 0 0" mass="2"
      diaginertia="0.01 0.01 0.01"/>
      {"".join(opened)}{fingers}{"".join(closed)}
    </body></worldbody>
  <equality><joint joint1="fb" joint2="fa" polycoef="0 1 0 0 0"
    solref="0.005 1" solimp="0.95 0.99 0.001"/></equality>
  <actuator>{motors}<motor joint="fa" gear="1" ctrlrange="-0.1 0.1"/>
  </actuator>
</mujoco>"""


def _chain_plan(tmp_path, links: int):
    from mujoco_rl_ur5_tpu_torch.physics.chain import make_chain_plan
    from mujoco_rl_ur5_tpu_torch.scene.reduce import load_arm_model
    path = tmp_path / "chain.xml"
    path.write_text(_chain_xml(links))
    return make_chain_plan(load_arm_model(str(path)))


@pytest.mark.parametrize("links", [3, 9])
def test_rollout_open_kernel_source_takes_other_chains(tmp_path, links):
    """Any chain plan runs on the team kernel: nv = 5 (one lane's role each
    and three inert ones) and nv = 11 (two roles per lane, five inert),
    both with a merged body, an unactuated dof and a joint equality,
    against float64 by phase 3's rule at a ragged batch."""
    plan = _chain_plan(tmp_path, links)
    nv, nu = plan.nv, plan.nu
    assert (nv, nu) == (links + 2, links)
    assert cc.team_plan(plan).nroles == -(-nv // cc.OPEN_TEAM) * cc.OPEN_TEAM
    fn = host_build(cc._open_src(plan), tmp_path)
    B, H, S = 37, 3, 2
    rng = np.random.default_rng(links)
    x0 = _t(np.concatenate([0.3 * rng.standard_normal((B, nv)),
                            0.5 * rng.standard_normal((B, nv))], -1))
    us = _t(0.8 * rng.standard_normal((B, H, nu)))
    assert cc.check_open_inputs(plan, x0, us) == (B, H)
    xs = torch.full((B, H + 1, 2 * nv), float("nan"))
    assert fn(x0.data_ptr(), us.data_ptr(), xs.data_ptr(), B, H, S,
              None) == 0
    _hold((xs,), (cc.rollout_open_plain(plan, S, x0, us),),
          (cc.rollout_open_plain(plan, S, x0.double(), us.double()),))


def test_team_plan_pads_inert_roles(tmp_path):
    """The inert roles of a padded plan: no actuator, no ancestor, a row
    and column of the identity in the masks of the mass matrix and its
    scaling, zeros in every sum over the roles."""
    plan = _chain_plan(tmp_path, 3)
    tp = cc.team_plan(plan)
    nv, nr = plan.nv, tp.nroles
    off, width = cc._team_offsets(nr)
    assert (nr, tp.rows.shape) == (8, (8, width))
    assert tp.act[nv:] == (-1,) * (nr - nv)
    assert all(j[nv:] == (-1,) * (nr - nv) for j in tp.jump)
    for name in ("WANC", "WSUB", "WM", "WS"):
        w = tp.rows[:, off[name]:off[name] + nr]
        want = np.eye(nr) if name in ("WM", "WS") else np.zeros((nr, nr))
        np.testing.assert_array_equal(w[nv:], want[nv:], err_msg=name)
        np.testing.assert_array_equal(w[:nv, nv:], 0.0, err_msg=name)
    inert = tp.rows[nv:].copy()
    inert[:, off["ADIAG"]] -= 1.0
    for name in ("WM", "WS"):
        inert[:, off[name] + nv:off[name] + nr] -= np.eye(nr - nv)
    assert not inert.any()
    header = cc.team_header(plan).text
    assert f"#define TEAM_NR {nr}" in header
    assert f"#define TEAM_NV {nv}" in header


@pytest.mark.parametrize("which, how", [
    (w, h) for w in ("x0", "us") for h in _HOWS] + [("x0", "unaligned")])
def test_rollout_open_input_check_raises(mpc, which, how):
    ins = {"x0": torch.zeros(3, 16), "us": torch.zeros(3, mpc.H, 7)}
    ins[which] = _bad(ins[which], how)
    with pytest.raises(ValueError, match="rollout_open"):
        cc.check_open_inputs(mpc.plan, ins["x0"], ins["us"])


def test_substep_header_text_is_unchanged(mpc):
    """lin_fd and rollout_closed build on the generated substep
    (chain_substep.cuh); tracking each value's depth in the emitter must
    not change its text, which stays byte for byte the one those kernels
    were measured with (its SHA-256 below). Its critical path: 140 levels."""
    import hashlib
    g = cc.substep_header(mpc.plan)
    assert hashlib.sha256(g.text.encode()).hexdigest() == (
        "637015756588c174b73e62ed1bb873bef020d377725f7255d39d30b84de7686f")
    assert g.ops["substep"] == 4312 and g.ops["depth"] == 140
    arith, exch = cc.team_depth(mpc.plan)
    assert arith > g.ops["depth"] and exch == 3 + 3 + 1 + 4 * 8 + 1
