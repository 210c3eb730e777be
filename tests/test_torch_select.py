"""The batched iLQR's best-alpha select decides as the JAX package's does.

JAX's ``ilqr_chain_batch`` (mpc/pallas_ilqr.py) takes the best candidate by
one-hot contractions, so one non-finite candidate cost (+inf or NaN) makes
the scenario's best cost NaN: the iteration is not an improvement there,
the plan is kept and the Levenberg-Marquardt regularisation grows x10. The
port's ``ilqr_chain_batch`` (mpc/cuda_ilqr.py) gathers the winner and must
decide the same. Both solvers run here on the same numpy-made inputs with
their heavy calls (the rollouts, the linearization and the Riccati pass)
replaced, in each module's own namespace, by the same cheap stand-ins: the
candidates' costs are a fixed table, their controls the plan's shifted by
alpha plus the feedforward term, which the stand-in backward sets to the
regularisation it receives. Compared: the returned cost, X and U (exactly:
both take the same float32 values), and the regularisation each backward
received, iteration by iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.mpc import pallas_ilqr
from mujoco_rl_ur5_tpu.mpc.lqr import Gains as JaxGains
from mujoco_rl_ur5_tpu_torch.mpc import cuda_ilqr
from mujoco_rl_ur5_tpu_torch.mpc.lqr import Gains

B, H, NX, NU, ITERS = 3, 3, 4, 2, 3
ALPHAS = cuda_ilqr.ALPHAS
START = 5.0          # every scenario's cost before the first iteration
# candidate costs per scenario (the same in every iteration): scenario 0
# is the case under test; scenario 1 never improves; scenario 2 improves
# once, at the first of its tied minima
FIRST = {"inf": (2.0, 1.0, np.inf, 3.0, 4.0),
         "nan": (2.0, 1.0, np.nan, 3.0, 4.0),
         "finite": (2.0, 1.0, 0.5, 3.0, 4.0)}
OTHERS = ((6.0, 7.0, 8.0, 9.0, 10.0), (4.0, 3.0, 3.0, 1.0, 1.0))


def _problem(case):
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal((B, NX)).astype(np.float32)
    u0 = rng.standard_normal((B, H, NU)).astype(np.float32)
    costs = np.array((FIRST[case],) + OTHERS, np.float32)
    return x0, u0, costs


def _tile(u, xp):
    """A control's effect on the state in the stand-in rollouts."""
    return xp.concatenate([u, u], -1)


def _roll(x0, steps):
    """The states of the stand-in rollout, added knot by knot (a library
    cumsum may add in another order)."""
    xs = [x0]
    for k in range(steps.shape[1]):
        xs.append(xs[-1] + steps[:, k])
    return xs


def _jax_solve(case, monkeypatch):
    x0, u0, costs = _problem(case)
    seen = []
    al = jnp.asarray(ALPHAS, jnp.float32)

    def rollout_open(plan, substeps, x0, us):
        return jnp.stack(_roll(x0, _tile(us, jnp)), 1)

    def lin_fd_fast(plan, substeps, xs, us):
        Bn, Hn = us.shape[:2]
        return (jnp.broadcast_to(jnp.eye(NX), (Bn, Hn, NX, NX)),
                jnp.zeros((Bn, Hn, NX, NU)))

    def backward_sequential(p, reg):
        return JaxGains(K=jnp.zeros((H, NU, NX)), d=reg * jnp.ones((H, NU)),
                        S=jnp.zeros((H + 1, NX, NX)),
                        s=jnp.zeros((H + 1, NX)))

    def rollout_closed(plan, substeps, x0, xbar, ubar, K, d, alphas,
                       cost=None, sref=None, tref=None):
        jax.debug.callback(lambda r: seen.append(np.asarray(r)), d[:, 0, 0],
                           ordered=True)
        us = ubar[:, None] + al[None, :, None, None] + d[:, None]
        xs = jax.vmap(lambda u: rollout_open(None, 1, x0, u), 1, 1)(us)
        return xs, us, jnp.asarray(costs)

    for name, fn in (("rollout_open", rollout_open),
                     ("lin_fd_fast", lin_fd_fast),
                     ("backward_sequential", backward_sequential),
                     ("rollout_closed", rollout_closed)):
        monkeypatch.setattr(pallas_ilqr, name, fn)
    res = pallas_ilqr.ilqr_chain_batch(
        None, 1,
        lambda x, u, ref: 0.0 * jnp.sum(x),
        lambda x, ref: START + 0.0 * jnp.sum(x),
        jnp.asarray(x0), jnp.asarray(u0), jnp.zeros((B, H, 1)),
        jnp.zeros((B, 1)), iters=ITERS, alphas=ALPHAS, reg=cuda_ilqr.REG,
        quad_fn=lambda x, u, ref: (jnp.zeros((NX, NX)), jnp.zeros(NX),
                                   jnp.zeros((NU, NU)), jnp.zeros(NU)),
        term_quad_fn=lambda x, ref: (jnp.zeros((NX, NX)), jnp.zeros(NX)),
        parallel_backward=False, kernel_cost=((None, None), None, None))
    jax.effects_barrier()
    return res, seen


def _port_solve(case, monkeypatch):
    x0, u0, costs = _problem(case)
    seen = []
    al = torch.tensor(ALPHAS, dtype=torch.float32)

    def rollout_open(plan, substeps, x0, us):
        return torch.stack(_roll(x0, _tile(us, torch)), 1)

    def lin_fd_fast(plan, substeps, xs, us):
        Bn, Hn = us.shape[:2]
        return (torch.eye(NX).expand(Bn, Hn, NX, NX),
                torch.zeros(Bn, Hn, NX, NU))

    def backward(F, L, X, q, U, r, XH, qH, rg):
        return Gains(K=torch.zeros(B, H, NU, NX),
                     d=rg[:, None, None] * torch.ones(B, H, NU),
                     S=torch.zeros(B, H + 1, NX, NX),
                     s=torch.zeros(B, H + 1, NX))

    def rollout_closed(plan, substeps, x0, xbar, ubar, K, d, alphas,
                       cost=None, sref=None, tref=None):
        seen.append(d[:, 0, 0].numpy().copy())
        us = ubar[:, None] + al[None, :, None, None] + d[:, None]
        xs = torch.stack([rollout_open(None, 1, x0, us[:, a])
                          for a in range(len(alphas))], 1)
        return xs, us, torch.from_numpy(costs)

    for name, fn in (("rollout_open", rollout_open),
                     ("lin_fd_fast", lin_fd_fast), ("backward", backward),
                     ("rollout_closed", rollout_closed)):
        monkeypatch.setattr(cuda_ilqr, name, fn)

    def quad(xs, us):
        Bn, Hn = us.shape[:2]
        return (torch.zeros(Bn, Hn, NX, NX), torch.zeros(Bn, Hn, NX),
                torch.zeros(Bn, Hn, NU, NU), torch.zeros(Bn, Hn, NU))

    res = cuda_ilqr.ilqr_chain_batch(
        None, 1, lambda xs, us: torch.full((xs.shape[0],), START), quad,
        lambda xH: (torch.zeros(xH.shape[0], NX, NX),
                    torch.zeros(xH.shape[0], NX)),
        torch.from_numpy(x0), torch.from_numpy(u0),
        ((None, None), None, None), iters=ITERS)
    return res, seen


@pytest.mark.parametrize("case", ["inf", "nan", "finite"])
def test_best_alpha_select_matches_jax(case, monkeypatch):
    jres, jseen = _jax_solve(case, monkeypatch)
    pres, pseen = _port_solve(case, monkeypatch)
    np.testing.assert_array_equal(pres.cost.numpy(), np.asarray(jres.cost))
    np.testing.assert_array_equal(pres.xs.numpy(), np.asarray(jres.xs))
    np.testing.assert_array_equal(pres.us.numpy(), np.asarray(jres.us))
    assert len(jseen) == len(pseen) == ITERS
    np.testing.assert_array_equal(np.stack(pseen), np.stack(jseen))
    reg = np.float32(cuda_ilqr.REG)
    # scenario 0: a non-finite candidate keeps the plan and grows the
    # regularisation; all finite, alpha 0.3 wins once and the plan moves
    cost0 = [float(c) for c in (pres.cost[0], jres.cost[0])]
    if case == "finite":
        assert cost0 == [0.5, 0.5]
        assert pseen[1][0] == reg
    else:
        assert cost0 == [START, START]
        np.testing.assert_array_equal(pres.us[0].numpy(),
                                      _problem(case)[1][0])
        assert [float(s[0]) for s in pseen] == [
            float(reg), float(reg * np.float32(10)),
            float(reg * np.float32(10) * np.float32(10))]
    # scenario 2: the first of the tied minima (alpha 0.1) wins
    assert float(pres.cost[2]) == 1.0
