"""The JAX package's scripted slide strike, with the puck's height read in
every step: `tests/test_acceptance.py:test_slide_scripted`'s expert
(`tests/policies.py:SlideExpert`) and episode loop on the single-env step of
`KukaSingleStepEnv` (the XLA engine), jitted once per function, on the CPU.
Prints one JSON line per episode: its steps, the puck's lowest and final
height, the steps with the puck at or under 0.16 m (its centre 10 mm or
more under its resting height), and the goal distances at the start and
the end.

    JAX_PLATFORMS=cpu python tests/jax_slide_strike.py [seed]

The reference against which `chip_smoke.py`'s strike phase reads the port:
a pad riding onto the puck's cap presses it into the table for a few steps
in this engine too. About a minute on 8 cores.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import pybullet_multigoal_gym_tpu  # noqa: E402,F401  (precision config)
from pybullet_multigoal_gym_tpu.config import EnvConfig  # noqa: E402
from pybullet_multigoal_gym_tpu.envs.single_step import (  # noqa: E402
    KukaSingleStepEnv)
from pybullet_multigoal_gym_tpu.ops import ik  # noqa: E402
from tests import policies  # noqa: E402

EPISODES, STEPS = 4, 150


def main(seed=0):
    core = KukaSingleStepEnv(EnvConfig(task='slide', joint_control=True,
                                       max_episode_steps=STEPS))
    reset, step = jax.jit(core.reset), jax.jit(core.step)
    rest = jnp.asarray(core.rest_pose)
    solve = jax.jit(lambda p, qi: ik.solve(p, q_init=qi, rest_pose=rest))

    def ik_solve(p, qi):
        return np.asarray(solve(jnp.asarray(p, jnp.float32),
                                jnp.asarray(qi, jnp.float32)))

    expert = policies.SlideExpert(ik_solve, np.asarray(core.rest_pose))
    key = jax.random.PRNGKey(seed)
    t0 = time.time()
    for ep in range(EPISODES):
        key, sub = jax.random.split(key)
        state, obs = reset(sub)
        obs = jax.tree_util.tree_map(np.asarray, obs)
        expert.reset()
        d0 = np.linalg.norm(obs['achieved_goal'][:2] - obs['desired_goal'][:2])
        zs = []
        for k in range(STEPS):
            state, obs, _, achieved = step(state, jnp.asarray(expert(obs)))
            obs = jax.tree_util.tree_map(np.asarray, obs)
            zs.append(float(obs['achieved_goal'][2]))
            if bool(achieved):
                break
        zs = np.asarray(zs)
        print(json.dumps(dict(
            seed=seed, episode=ep, steps=k + 1, goal_achieved=bool(achieved),
            puck_lowest_z=float(zs.min()), puck_z_at_end=float(zs[-1]),
            steps_with_puck_under_016=int((zs <= 0.16).sum()),
            initial_goal_distance=float(d0),
            final_goal_distance=float(np.linalg.norm(
                obs['achieved_goal'][:2] - obs['desired_goal'][:2])),
            seconds=time.time() - t0)), flush=True)


if __name__ == '__main__':
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
