"""Helpers shared by the port's tests (tests/test_torch_*.py). Imports no
JAX, so that the card-only tests run where JAX is not installed."""

import numpy as np
import pytest
import torch

from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP

ARM_FIELDS = ('q', 'qd', 'fq', 'fqd')
BODY_FIELDS = ('body_pos', 'body_quat', 'body_linvel', 'body_angvel')


@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (the kernels have no CPU
    mode, so their tests run only on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the hand-written kernels run only '
                    'on the card')
    return torch.device('cuda')


def t(x, device='cpu'):
    """numpy -> float32 torch tensor."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def n(x):
    """torch / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def workspace_targets(rng, count):
    """Tip targets from the IK workspace box of the JAX package's own IK
    test (tests/test_pallas_engine.py)."""
    return rng.uniform([-0.62, -0.15, 0.2], [-0.42, 0.15, 0.45],
                       (count, 3)).astype(np.float32)


def mk_state(has_obj, count, seed=0, z=0.21):
    """The state of tests/test_pallas_engine.py: rest pose, fingers at 0, a
    box dropped near the fingers (numpy leaves, (count, ...))."""
    rng = np.random.default_rng(seed)
    bp = (np.array([[-0.5, 0.05, z]]) + rng.uniform(-0.02, 0.02, (count, 1, 3))
          ).astype(np.float32)
    if not has_obj:
        bp = np.zeros((count, 1, 3), np.float32)
    z3 = np.zeros((count, 1, 3), np.float32)
    return dict(
        q=np.tile(np.asarray(KM.KUKA_REST_POSE, np.float32), (count, 1)),
        qd=np.zeros((count, 7), np.float32), fq=np.zeros((count, 2), np.float32),
        fqd=np.zeros((count, 2), np.float32), body_pos=bp,
        body_quat=np.tile(np.array([[[1.0, 0, 0, 0]]], np.float32),
                          (count, 1, 1)),
        body_linvel=z3, body_angvel=z3, door_q=np.zeros(count, np.float32),
        door_qd=np.zeros(count, np.float32),
        ee_contact_force=np.zeros((count, 3), np.float32))


# IK solution for the tip at (-0.52, 0, 0.175): finger pads 15 mm above the
# table plane
_Q_LOW = np.array([0.0, -0.6859, 0.0, 1.7677, 0.0, -0.688, 0.0], np.float32)


def mk_contact_state(has_obj, count, seed=0):
    """A moving arm low over the table with the box between the finger pads:
    finger-box, finger-plane and arm-sphere lanes are active in many envs,
    so the solve, the finger and arm coupling and the EE force all act."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    st = mk_state(has_obj, count, seed)
    st.update(q=_Q_LOW + u(-0.03, 0.03, (count, 7)), qd=u(-0.2, 0.2, (count, 7)),
              fq=u(0.0, 0.035, (count, 2)), fqd=u(-0.05, 0.05, (count, 2)))
    if has_obj:
        bq = np.concatenate([np.ones((count, 1, 1), np.float32),
                             u(-0.1, 0.1, (count, 1, 3))], -1)
        st.update(body_pos=(np.array([[-0.52, 0.0, 0.185]], np.float32)
                            + u(-0.01, 0.01, (count, 1, 3))),
                  body_quat=bq / np.linalg.norm(bq, axis=-1, keepdims=True),
                  body_linvel=u(-0.05, 0.05, (count, 1, 3)))
    return st


def mk_controls(count, state=None, seed=0):
    """Hold the rest pose with the fingers closing; with ``state``, servo
    toward a target near the state's configuration instead."""
    rng = np.random.default_rng(seed + 1)
    qt = np.tile(np.asarray(KM.KUKA_REST_POSE, np.float32), (count, 1))
    ft = np.full((count, 2), 0.035, np.float32)
    if state is not None:
        qt = state['q'] + rng.uniform(-0.05, 0.05, (count, 7)).astype(np.float32)
        ft = rng.uniform(-0.035, 0.035, (count, 2)).astype(np.float32)
    return dict(
        q_target=qt, f_target=ft,
        door_motor_on=np.zeros(count, bool),
        door_target=np.zeros(count, np.float32))


def torch_state(d, device='cpu'):
    return D.PhysicsState(**{k: torch.as_tensor(v, device=device)
                             for k, v in d.items()})


def torch_controls(d, device='cpu'):
    return D.Controls(**{k: torch.as_tensor(v, device=device)
                         for k, v in d.items()})


def inputs(has_obj, kind, count, seed=0):
    """Physics state and controls (numpy): 'drop' (the JAX package's test
    state) or 'contact' (mk_contact_state)."""
    if kind == 'drop':
        return mk_state(has_obj, count, seed), mk_controls(count)
    st = mk_contact_state(has_obj, count, seed)
    return st, mk_controls(count, st, seed)


def lane_group(lane):
    """The contact-lane group of a plain-version lane, from its metadata."""
    if lane.finger_idx >= 0:
        return 'finger-box' if lane.body_sgn else 'finger-plane'
    if lane.link >= 0:
        return 'sphere-box' if lane.body_sgn else 'sphere-plane'
    return 'box-plane'


def plain_run(sc, st, ctl, n_sub, noise_seed=None):
    """The plain control step (ops/engine_plain.py, substep by substep, as
    its `control_step` runs it). Returns the state after it and, per lane
    group, the share of envs where a lane of the group is active in some
    substep. With ``noise_seed``, every element of the state moves by -1, 0
    or +1 ulp (seeded) before each substep instead, and no shares are
    kept: the spread of such runs is the plain version's own sensitivity to
    rounding, which enters a run at every substep."""
    carry = (st.q, st.qd, st.fq, st.fqd, st.body_pos[:, 0],
             st.body_quat[:, 0], st.body_linvel[:, 0], st.body_angvel[:, 0])
    g = None if noise_seed is None else torch.Generator(
        device=st.q.device).manual_seed(noise_seed)
    active = {}
    ee = st.ee_contact_force
    for _ in range(n_sub):
        if g is None:
            q, _, fq, _, bp, bq, _, _ = carry
            Ra = EP.qmat(bq) if sc.has_body else None
            for lane in EP.build_lanes(sc, EP.fk_chain(q, fq), bp, bq, Ra):
                grp = lane_group(lane)
                active[grp] = active.get(grp, False) | (lane.active > 0)
        else:
            carry = tuple(torch.nextafter(x, x + torch.randint(
                -1, 2, x.shape, generator=g, device=x.device).to(x.dtype))
                for x in carry)
        carry, ee = EP.substep(sc, carry, ctl.q_target, ctl.f_target)
    q, qd, fq, fqd, bp, bq, bv, bw = carry
    out = st._replace(q=q, qd=qd, fq=fq, fqd=fqd, body_pos=bp[:, None],
                      body_quat=bq[:, None], body_linvel=bv[:, None],
                      body_angvel=bw[:, None], ee_contact_force=ee)
    return out, {k: float(v.float().mean()) for k, v in sorted(active.items())}
