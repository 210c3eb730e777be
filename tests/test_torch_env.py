"""The port's GraspEnv against the JAX package's, on the object fixture
(assets/ur5_2finger_objects.xml; JAX's compiled arrays carried across with
``carry.model_from_arrays``), at the sizes of tests/test_env.py: ncon=96,
iterations=15, a 32 x 32 camera, B=4, budget_scale=0.005 (2 settle steps
and 46 phase steps: the roll stays on one trajectory).

* The draw comes across from JAX: JAX's ``reset`` on four keys (its draw
  read where it enters the settle) and the port's settle of that draw:
  qpos and qvel within 1e-4, setpoints equal, the observation as below;
  ``carry.env_state_from_arrays`` takes JAX's settled EnvState across
  with every array and dtype equal.
* One ``step`` from the settled piles, four scenarios chosen so that every
  branch runs: (a) a floor pixel beyond the bin (z < 0.8: skipped); (b) a
  pixel decoded at y = -0.92, whose pre-grasp JAX's ``ik_solve`` misses
  (the centre fallback; its depth set to 0.95 m in both inputs); (c) the
  arm placed at the IK solution of (0, -0.6, 1.1) with its setpoints
  there, the gripper at 0, the pixel above the bin's centre at depth
  0.89 m (z = 1.11, so c2 = c1): phases 0-4 end at once, the close does
  not converge, and the transport, the final check and the settle run;
  (d) the scenario's closest pixel, as bench.py picks it. Held against
  JAX: ``decode_action`` (1e-5 m), the skip gate, every phase flag (JAX's
  read from the phase scan's final carry), ``reward`` and
  ``info["grasped"]``, qpos and qvel within 1e-4, the setpoints within
  1e-4 and Kp equal.
* Observation: the port's ``observe`` of JAX's state against JAX's
  ``render_rgbd`` of that state, run op by op as tests/test_torch_render.py
  runs it (under jit XLA may contract multiply-adds): the winning geom (the
  port's plain cast, JAX's ``_cast_all``) equal on >= 99.9% of the pixels;
  where it is, rgb within 1 level and the depth buffer within 1e-6, times
  0.2 / |n.d| where the ray meets the surface at |n.d| < 0.2 (a grazing
  hit's depth is ill-conditioned: a sphere's discriminant cancels, and one
  pixel of scenario (b) at |n.d| = 0.16 parts by 1.07e-6).
* ``reset`` through a generator holds JAX's invariants
  (tests/test_env.py): the arm near home, the objects inside the drop's
  envelope with unit quaternions, seeds that differ, finite depth between
  0.2 and 2.1 m; ``step`` on CUDA where there is none raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.env import GraspEnv as JGraspEnv
from mujoco_rl_ur5_tpu.physics.kinematics import fk as jax_fk
from mujoco_rl_ur5_tpu.render import camera as jcamera
from mujoco_rl_ur5_tpu.render import raycast as jraycast
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu_torch import OBJECTS, carry
from mujoco_rl_ur5_tpu_torch.carry import model_from_arrays
from mujoco_rl_ur5_tpu_torch.control.ik import ik_solve
from mujoco_rl_ur5_tpu_torch.env import GraspEnv
from mujoco_rl_ur5_tpu_torch.env.grasp_env import FLAGS, HOME
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
from mujoco_rl_ur5_tpu_torch.render import camera, raycast
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS

B, W = 4, 32
KW = dict(ncon=96, iterations=15, image_width=W, image_height=W,
          budget_scale=0.005)
GRAZE = 0.2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops are small: one thread runs them faster here and
    leaves the other workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def envs():
    jm = jax_compile_spec(jax_parse_mjcf(OBJECTS))
    m = model_from_arrays(compile_file(OBJECTS).topo,
                          {n: np.asarray(getattr(jm, n))
                           for n in ARRAY_FIELDS})
    return JGraspEnv(jm, **KW), GraspEnv(m, device="cpu", **KW)


@pytest.fixture(scope="module")
def settled(envs):
    """JAX's reset on four keys, with its draw; the port's settle of it."""
    jenv, env = envs

    def reset(key):
        box = {}
        stay = jenv.ctl.stay

        def recording(sim, cstate, ms):
            box["qpos"] = sim.qpos
            return stay(sim, cstate, ms)

        jenv.ctl.stay = recording
        try:
            es = jenv.reset(key)
        finally:
            del jenv.ctl.stay
        return es, box["qpos"]

    jes, drawn = jax.jit(jax.vmap(reset))(
        jax.random.split(jax.random.PRNGKey(0), B))
    es = env._settle(torch.from_numpy(np.array(drawn)))
    return jes, es


def _same_state(sim, jsim):
    for a, b in ((sim.qpos, jsim.qpos), (sim.qvel, jsim.qvel)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def _observation_matches(env, jenv, jes):
    """The port's observe of JAX's state against JAX's renderer on that
    state, op by op (jit would let XLA contract multiply-adds)."""
    sim = carry.state_from_arrays(jes.sim)
    rgb, depth = env.observe(sim)
    m, cam, jm, jcam = env.model, env.cam, jenv.model, jenv.cam
    kin = fk(m, sim.qpos)
    rgb2, dbuf = raycast.render_rgbd(m, kin, cam)
    assert torch.equal(rgb, rgb2)
    np.testing.assert_array_equal(depth.numpy(), camera.depth_2_meters(
        cam, dbuf).numpy())
    par, code, faces = raycast.geom_table(m, kin, cam)
    _, gid, nrm = raycast.cast_plain(par, code, faces, cam.dirs)
    gid = gid.numpy()
    # a hit's depth is conditioned by 1 / |n.d|: past GRAZE the limit grows
    # with it
    cond = np.minimum(1.0, (nrm * cam.dirs).sum(-1).abs().numpy() / GRAZE)
    dirs = jcamera.camera_rays(jcam).reshape(-1, 3)
    dn = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    mask = jnp.asarray(np.asarray(jm.geom_rgba)[:, 3] > 0.01)
    for b in range(sim.qpos.shape[0]):
        jkin = jax_fk(jm, jes.sim.qpos[b])
        jrgb, jdbuf = jraycast.render_rgbd(jm, jkin, jcam, use_pallas=False)
        s, _ = jraycast._cast_all(jm, jkin, jcam.pos, dn)
        jg = np.asarray(jnp.argmin(jnp.where(mask[None], s, jraycast.BIG),
                                   1))
        same = (gid[b] == jg).reshape(W, W)[::-1, ::-1]
        assert same.mean() >= 0.999, same.mean()
        err = np.abs(dbuf[b].numpy() - np.asarray(jdbuf)) * cond[b].reshape(
            W, W)[::-1, ::-1]
        assert err[same].max() <= 1e-6, err[same].max()
        drgb = np.abs(rgb[b].numpy().astype(int) - np.asarray(jrgb))
        assert drgb[same].max() <= 1


def test_settle_of_jax_draw_matches(envs, settled):
    jenv, env = envs
    jes, es = settled
    _same_state(es.sim, jes.sim)
    np.testing.assert_array_equal(es.ctl.setpoints.numpy(),
                                  np.asarray(jes.ctl.setpoints))
    assert es.rgb.shape == (B, W, W, 3) and es.rgb.dtype == torch.uint8
    _observation_matches(env, jenv, jes)
    # JAX's EnvState carried across as it is (its key has no counterpart)
    ces = carry.env_state_from_arrays(jes)
    for got, want in ((ces.sim.qpos, jes.sim.qpos), (ces.rgb, jes.rgb),
                      (ces.depth, jes.depth), (ces.ctl.pid.primed,
                                               jes.ctl.pid.primed),
                      (ces.ctl.setpoints, jes.ctl.setpoints),
                      (ces.ctl.params.kp, jes.ctl.params.kp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ces.rgb.dtype == torch.uint8 and ces.ctl.pid.primed.dtype == \
        torch.bool


def _scenarios(env, jes, es):
    """The four actions and the inputs changed for (b) and (c), applied
    alike to both packages' states."""
    d = es.depth.numpy()
    t = env.model.topo
    floor = np.argwhere(d[0] > 1.3)
    floor = floor[floor[:, 0] >= W - 4][0]              # beyond the bin
    pix = [floor[0] * W + floor[1], 29 * W + 16, 16 * W + 16,
           int(np.argmin(d[3]))]
    actions = np.array([[pix[0], 0], [pix[1], 2], [pix[2], 0], [pix[3], 3]])
    depth = d.copy()
    depth[1, 29, 16], depth[2, 16, 16] = 0.95, 0.89
    qpos = es.sim.qpos.clone()
    qpos[2, 5] = 0.0                                   # wrist_3
    gq = env.ctl.act_qadr[6]
    grip = [gq] + [t.jnt_qposadr[t.joint_id(n)] for n in t.joint_names
                   if n.startswith("base_to_") and
                   t.jnt_qposadr[t.joint_id(n)] != gq]
    qpos[2, grip] = 0.0
    q5, _, ok = ik_solve(env.model, env.ctl.chain,
                         torch.tensor([[0.0, -0.6, 1.1]]), qpos[2:3])
    assert bool(ok[0])
    qpos[2, :5] = q5[0]
    sp = es.ctl.setpoints.clone()
    sp[2] = torch.cat([q5[0], torch.zeros(2)])
    es = es.replace(sim=es.sim.replace(qpos=qpos),
                    ctl=es.ctl.replace(setpoints=sp),
                    depth=torch.from_numpy(depth))
    jes = jes.replace(sim=jes.sim.replace(qpos=jnp.asarray(qpos.numpy())),
                      ctl=jes.ctl.replace(setpoints=jnp.asarray(sp.numpy())),
                      depth=jnp.asarray(depth))
    return actions, jes, es


def _jax_step_with_flags(jenv):
    """JAX's step, vmapped and jitted, also returning its phase flags: the
    final carry of the phase scan, read while JAX traces move_and_grasp."""
    def step(es, action):
        seen = []
        scan = jax.lax.scan

        def recording(f, init, xs=None, length=None, **kw):
            out = scan(f, init, xs, length=length, **kw)
            seen.append((init, out[0]))
            return out

        jax.lax.scan = recording
        try:
            out = jenv.step(es, action)
        finally:
            jax.lax.scan = scan
        fl = [c[6] for i, c in seen if isinstance(i, tuple) and len(i) == 7
              and isinstance(i[6], tuple) and len(i[6]) == 7]
        assert len(fl) == 1
        return out, fl[0]

    return jax.jit(jax.vmap(step))


def test_step_matches_jax(envs, settled):
    jenv, env = envs
    actions, jes, es = _scenarios(env, *settled)
    coords, rot = env.decode_action(es, torch.from_numpy(actions))
    jcoords, jrot = jax.vmap(jenv.decode_action)(jes, jnp.asarray(actions))
    np.testing.assert_allclose(coords.numpy(), np.asarray(jcoords),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(rot.numpy(), np.asarray(jrot))
    c = coords.numpy()
    assert c[0, 2] < 0.8 and c[0, 1] <= -0.3           # (a) the z gate
    assert c[1, 1] < -0.85 and c[1, 2] > 0.8
    np.testing.assert_allclose(c[2], [0.0, -0.6, 1.11], atol=1e-4)

    es2, reward, done, info = env.step(es, torch.from_numpy(actions))
    (jes2, jreward, jdone, jinfo), jfl = _jax_step_with_flags(jenv)(
        jes, jnp.asarray(actions))
    flags = {k: info["phases"][k].numpy() for k in FLAGS}
    for k, v in zip(FLAGS, jfl):
        np.testing.assert_array_equal(flags[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
    np.testing.assert_array_equal(info["grasped"].numpy(),
                                  np.asarray(jinfo["grasped"]))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    _same_state(es2.sim, jes2.sim)
    np.testing.assert_allclose(es2.ctl.setpoints.numpy(),
                               np.asarray(jes2.ctl.setpoints), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(es2.ctl.params.kp.numpy(),
                                  np.asarray(jes2.ctl.params.kp))
    # the branches: (a) skipped and untouched, (b) the IK miss and the
    # centre fallback, (c) grasp, transport, final check and settle
    np.testing.assert_array_equal(es2.sim.qpos[0].numpy(),
                                  es.sim.qpos[0].numpy())
    assert not flags["ik1_ok"][1]
    assert flags["ik1_ok"][2] and flags["r1s"][2] and flags["rd_s"][2]
    assert flags["grasp_ok"][2] and flags["grasped"][2]
    assert reward.tolist()[0] == 0.0 and reward.tolist()[2] == 1.0
    _observation_matches(env, jenv, jes2)


def test_reset_holds_the_reference_invariants(envs):
    jenv, env = envs
    es = env.reset(torch.Generator().manual_seed(0), 3)
    es1 = env.reset(torch.Generator().manual_seed(1), 3)
    qpos = es.sim.qpos.numpy()
    np.testing.assert_allclose(qpos[:, env.ctl.act_qadr],
                               np.tile(HOME, (3, 1)), atol=0.3)
    qa = env.free_qadr
    assert env.nobj == 40
    x, y, z = qpos[:, qa], qpos[:, qa + 1], qpos[:, qa + 2]
    assert (np.abs(x) < 0.6).all() and ((y > -1.1) & (y < 0.0)).all()
    assert ((z > 0.2) & (z < 1.55)).all()
    quats = np.stack([qpos[:, qa + 3 + k] for k in range(4)], -1)
    np.testing.assert_allclose(np.linalg.norm(quats, axis=-1), 1.0,
                               atol=1e-3)
    assert np.abs(qpos[:, qa] - es1.sim.qpos.numpy()[:, qa]).max() > 0.01
    d = es.depth.numpy()
    assert es.depth.shape == (3, W, W) and np.isfinite(d).all()
    assert d.min() > 0.2 and d.max() <= 2.1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            GraspEnv(env.model, device="cuda", **KW)
