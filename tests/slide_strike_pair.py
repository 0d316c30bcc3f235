"""The port's scripted slide strike beside the JAX package's, on the CPU,
from the same states with the same actions.

`chip_smoke.py`'s strike phase drives `make_env(task='slide',
joint_control=True, max_episode_steps=150, seed=0)` on the card with
`tests/policies.py:SlideExpert` (IK: the port's `ops/ik.solve`) for 4
episodes. This script drives the same env on the CPU (K2's plain version)
and, beside it, the JAX package's `KukaSingleStepEnv.step` (its XLA engine,
traced with the Pallas kernel's pad-on-cap point, which the port follows:
`tests/test_torch_slide.py:_pallas_vertical_point`): each episode starts
both from the port's reset state (carried across in the path-keyed
checkpoint format, `interop.py`), and every step gives both the action the
expert takes on the port's observation. Prints one JSON line per episode:
its steps, the puck's lowest height in each engine, the steps with the
puck at or under 0.16 m in each, and the largest difference of the puck's
position between them.

    JAX_PLATFORMS=cpu python tests/slide_strike_pair.py [episodes] [seed]
    python tests/slide_strike_pair.py dump STATES.npz        # on the card
    JAX_PLATFORMS=cpu python tests/slide_strike_pair.py states STATES.npz

The CPU's reset draws differ from the card's (another generator), so
`dump` saves the reset states of `chip_smoke.py`'s strike on the card (no
JAX there; its episodes draw nothing but their resets), and `states`
starts the episodes from them. About 4 minutes an episode on one core,
nearly all of it the port's plain control steps.
"""

import contextlib
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import pybullet_multigoal_gym_tpu_torch as port  # noqa: E402
from pybullet_multigoal_gym_tpu_torch import interop  # noqa: E402
from pybullet_multigoal_gym_tpu_torch.adapter import _first  # noqa: E402
from pybullet_multigoal_gym_tpu_torch.ops import ik  # noqa: E402
from tests.policies import SlideExpert  # noqa: E402

EPISODES, STEPS = 4, 150


def make(seed, device):
    with contextlib.redirect_stdout(sys.stderr):    # make_env's id line
        return port.make_env(task='slide', joint_control=True,
                             max_episode_steps=STEPS, seed=seed,
                             device=device)


def dump(path, episodes=EPISODES):
    """The reset states of `chip_smoke.py`'s strike, one per episode."""
    env = make(0, None)
    leaves = {}
    for ep in range(episodes):
        env.reset()
        leaves.update({'%d%s' % (ep, k): v for k, v in
                       interop.state_to_numpy(env._state).items()})
    np.savez(path, **leaves)


def jax_state(template, leaves):
    """The JAX single-env state ``template`` with every leaf that the port's
    state has (one env, its batch axis dropped) taken from ``leaves``."""
    import jax
    import jax.numpy as jnp
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in flat:
        name = re.sub(r'[^A-Za-z0-9_.]', '_', jax.tree_util.keystr(path))
        if name in leaves:
            v = np.asarray(leaves[name])[0]
            assert v.shape == leaf.shape, (name, v.shape, leaf.shape)
            leaf = jnp.asarray(v, leaf.dtype)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


def pair(episodes=EPISODES, seed=0, states=None):
    import jax
    import jax.numpy as jnp

    import pybullet_multigoal_gym_tpu  # noqa: F401  (precision config)
    from pybullet_multigoal_gym_tpu.config import EnvConfig
    from pybullet_multigoal_gym_tpu.envs.single_step import KukaSingleStepEnv
    from pybullet_multigoal_gym_tpu.ops import contact as JC
    from tests.test_torch_slide import _pallas_vertical_point
    torch.set_num_threads(1)
    env = make(seed, 'cpu')
    core = env.venv.core
    rest = torch.as_tensor(core.rest_pose)

    def ik_solve(p, qi):
        return ik.solve(torch.as_tensor(p, dtype=torch.float32),
                        q_init=torch.as_tensor(qi, dtype=torch.float32),
                        rest_pose=rest).numpy()

    expert = SlideExpert(ik_solve, core.rest_pose)
    jcore = KukaSingleStepEnv(EnvConfig(task='slide', joint_control=True,
                                        max_episode_steps=STEPS))
    template, _ = jax.jit(jcore.reset)(jax.random.PRNGKey(0))
    # traced at the first call, with the Pallas kernel's pad-on-cap point
    JC.box_cylinder_upright = _pallas_vertical_point(JC.box_cylinder_upright)
    step = jax.jit(jcore.step)
    saved = None if states is None else np.load(states)
    t0 = time.time()
    for ep in range(episodes):
        obs = env.reset()
        if saved is not None:
            env._state = interop.state_from_numpy(
                {k[len(str(ep)):]: saved[k] for k in saved.files
                 if k.startswith('%d.' % ep)}, device='cpu')
            obs = _first(core._get_obs(env._state))
        expert.reset()
        d0 = np.linalg.norm(obs['achieved_goal'][:2] - obs['desired_goal'][:2])
        js = jax_state(template, interop.state_to_numpy(env._state))
        zs, jzs, apart = [], [], 0.0
        for k in range(STEPS):
            action = expert(obs)
            obs, _, _, info = env.step(action)
            js, jobs, _, jach = step(js, jnp.asarray(action))
            puck = obs['achieved_goal']
            jpuck = np.asarray(jobs['achieved_goal'])
            zs.append(float(puck[2]))
            jzs.append(float(jpuck[2]))
            apart = max(apart, float(np.abs(puck - jpuck).max()))
            if info['goal_achieved']:
                break
        zs, jzs = np.asarray(zs), np.asarray(jzs)
        print(json.dumps(dict(
            states=states or 'seed %d' % seed, episode=ep, steps=k + 1,
            initial_goal_distance=float(d0),
            goal_achieved=info['goal_achieved'],
            jax_goal_achieved=bool(jach),
            puck_lowest_z=float(zs.min()), jax_puck_lowest_z=float(jzs.min()),
            step_of_lowest_z=int(zs.argmin()) + 1,
            jax_step_of_lowest_z=int(jzs.argmin()) + 1,
            steps_with_puck_under_016=int((zs <= 0.16).sum()),
            jax_steps_with_puck_under_016=int((jzs <= 0.16).sum()),
            puck_max_abs_diff=apart, seconds=time.time() - t0)), flush=True)


if __name__ == '__main__':
    args = sys.argv[1:]
    if args[:1] == ['dump']:
        dump(args[1])
    elif args[:1] == ['states']:
        pair(states=args[1])
    else:
        pair(*(int(a) for a in args[:2]))
