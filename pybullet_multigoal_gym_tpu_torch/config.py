"""Frozen, hashable env configuration — the static counterpart of the
reference's `make_env` keyword surface
(`pybullet_multigoal_gym/__init__.py:4-11`) plus the
per-family constructor flags the task classes hard-code
(`envs/task_envs/kuka_single_step_envs.py`, `kuka_multi_step_envs.py`, ...).
"""

import dataclasses
from typing import Optional, Tuple

TASKS = ('push', 'reach', 'slide', 'pick_and_place',
         'block_stack', 'block_rearrange', 'chest_pick_and_place', 'chest_push',
         'primitive_push_assemble', 'primitive_push_reach', 'insertion')
GRIPPERS = ('robotiq85', 'parallel_jaw')

SINGLE_STEP_TASKS = ('push', 'reach', 'slide', 'pick_and_place')
MULTI_STEP_TASKS = ('block_stack', 'block_rearrange', 'chest_pick_and_place',
                    'chest_push')
PRIMITIVE_TASKS = ('primitive_push_assemble', 'primitive_push_reach')


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static configuration of one env family instance."""
    task: str = 'reach'
    gripper: str = 'parallel_jaw'
    num_block: int = 5
    binary_reward: bool = True
    grip_informed_goal: bool = False
    task_decomposition: bool = False
    joint_control: bool = False
    max_episode_steps: int = 50
    distance_threshold: float = 0.05
    primitive: Optional[str] = None
    image_observation: bool = False
    depth_image: bool = False
    goal_image: bool = False
    point_cloud: bool = False
    state_noise: bool = False
    visualize_target: bool = True
    observation_cam_id: Tuple[int, ...] = (0,)
    goal_cam_id: int = 0
    use_curriculum: bool = False
    num_goals_to_generate: int = 1_000_000
    render_width: int = 128
    render_height: int = 128
    # user camera rig, frozen to a hashable tuple of (eye, target, up, w, h)
    # tuples (reference passes a list of dicts, base_env.py:47-58)
    camera_setup: Optional[Tuple] = None

    @staticmethod
    def freeze_camera_setup(setups):
        """list-of-dicts (reference format) -> hashable nested tuples."""
        if setups is None:
            return None
        out = []
        for s in setups:
            out.append((tuple(float(x) for x in s['cameraEyePosition']),
                        tuple(float(x) for x in s['cameraTargetPosition']),
                        tuple(float(x) for x in s['cameraUpVector']),
                        int(s['render_width']), int(s['render_height'])))
        return tuple(out)

    @property
    def camera_setup_dicts(self):
        if self.camera_setup is None:
            return None
        return [dict(cameraEyePosition=list(e), cameraTargetPosition=list(t),
                     cameraUpVector=list(u), render_width=w, render_height=h)
                for (e, t, u, w, h) in self.camera_setup]

    # ------------------------------------------------------------ derived
    @property
    def family(self) -> str:
        if self.task in SINGLE_STEP_TASKS:
            return 'single_step'
        if self.task in MULTI_STEP_TASKS:
            return 'multi_step'
        if self.task in PRIMITIVE_TASKS:
            return 'shape_assemble'
        return 'insertion'

    @property
    def has_obj(self) -> bool:
        return self.task != 'reach'

    @property
    def grasping(self) -> bool:
        # kuka_single_step_envs.py / kuka_multi_step_envs.py constructor flags
        return self.task in ('pick_and_place', 'block_stack',
                             'chest_pick_and_place', 'insertion')

    @property
    def table_type(self) -> str:
        return 'long_table' if self.task == 'slide' else 'table'

    @property
    def target_in_the_air(self) -> bool:
        return self.task in ('reach', 'pick_and_place')

    @property
    def end_effector_start_on_table(self) -> bool:
        return self.task in ('push', 'slide', 'block_rearrange', 'chest_push')

    @property
    def has_chest(self) -> bool:
        return self.task in ('chest_pick_and_place', 'chest_push')

    @property
    def chest_door(self) -> str:
        return 'up_sliding' if self.task == 'chest_pick_and_place' else 'front_sliding'

    @property
    def obj_range(self) -> float:
        if self.task == 'slide':
            return 0.1
        if self.task in ('chest_pick_and_place', 'chest_push'):
            return 0.1
        if self.family in ('shape_assemble', 'insertion'):
            return 0.1
        return 0.15

    @property
    def target_range(self) -> float:
        return 0.2 if self.task == 'slide' else 0.15

    @property
    def num_curriculum(self) -> int:
        if self.task in ('chest_pick_and_place', 'chest_push'):
            return self.num_block + 1
        return self.num_block

    @property
    def num_steps(self) -> int:
        """Task-decomposition sub-goal count (kuka_multi_step_envs.py)."""
        n = self.num_block
        if self.task == 'block_stack':
            return n * 2 if self.grip_informed_goal else n
        if self.task == 'chest_pick_and_place':
            return n * 3 + 1 if self.grip_informed_goal else n + 1
        if self.task == 'chest_push':
            return n * 2 + 1 if self.grip_informed_goal else n + 1
        return 1

    @property
    def chest_door_opened_state(self) -> float:
        # kuka_multi_step_base_env.py:106-109
        return 0.1 if self.grasping else 0.12

    @property
    def end_effector_rotation_control(self) -> bool:
        return self.task == 'insertion'

    @property
    def end_effector_force_sensor(self) -> bool:
        return self.task == 'insertion'

    @property
    def table_surface_z(self) -> float:
        # Kuka(table_surface_z=0.04) for primitive/insertion families,
        # default 0.175 otherwise (kuka.py:11, *_base_env.py robot ctor)
        if self.family in ('shape_assemble', 'insertion'):
            return 0.04
        return 0.175

    @property
    def render_mode(self) -> str:
        return 'rgbd_array' if self.depth_image else 'rgb_array'

    @property
    def manipulated_object_keys(self) -> Tuple[str, ...]:
        if self.task == 'primitive_push_assemble':
            return ('slot', 'cube')
        if self.task == 'primitive_push_reach':
            return ('rectangle',)
        if self.task == 'insertion':
            return ('slot', 'rectangle')
        return ()

    @property
    def goal_object_key(self) -> str:
        if self.task == 'primitive_push_assemble':
            return 'cube'
        return 'rectangle'

    @property
    def orientation_informed_goal(self) -> bool:
        return self.family in ('shape_assemble', 'insertion')

    @property
    def regenerate_goal_when_step(self) -> bool:
        # KukaPushAssembleEnv regenerates every step
        # (kuka_shape_assemble_envs.py:16)
        return self.task == 'primitive_push_assemble'

    @property
    def action_dim(self) -> int:
        """Continuous action dimension (kuka.py:77-118)."""
        if self.primitive is not None:
            return 3
        if self.joint_control:
            return 8 if self.grasping else 7
        if self.end_effector_rotation_control:
            return 7 if self.grasping else 6
        return 4 if self.grasping else 3

    def validate(self):
        assert self.task in TASKS, \
            'invalid task name: {}, only support: {}'.format(self.task, TASKS)
        assert self.gripper in GRIPPERS, \
            'invalid gripper: {}, only support: {}'.format(self.gripper, GRIPPERS)
        if self.family == 'multi_step':
            assert self.num_block <= 5, 'only support up to 5 blocks'
        if self.family == 'shape_assemble':
            assert self.primitive in ('discrete_push', 'continuous_push')
        if self.task == 'block_rearrange':
            assert not self.grip_informed_goal, \
                'Block rearranging task does not support gripper informed goal representation.'
            assert not self.task_decomposition, \
                'Block rearranging task does not support task decomposition.'
        if self.has_chest:
            assert not self.goal_image, \
                'Chest tasks do not support goal images well at the moment.'
        if self.task_decomposition:
            assert not self.use_curriculum
        if self.use_curriculum:
            assert not self.task_decomposition
        return self


def env_id(cfg: EnvConfig, render: bool = False) -> str:
    """Reproduce the reference env-id string scheme (__init__.py:19-83)."""
    tags = {
        'reach': 'Reach', 'push': 'Push', 'pick_and_place': 'PickAndPlace',
        'slide': 'Slide', 'block_stack': 'BlockStack',
        'block_rearrange': 'BlockRearrangeEnv',
        'chest_pick_and_place': 'ChestPickAndPlace', 'chest_push': 'ChestPush',
        'primitive_push_assemble': 'ShapeAssemble',
        'primitive_push_reach': 'PrimPushReach', 'insertion': 'Insertion',
    }
    eid = 'Kuka' + tags[cfg.task]
    eid += 'ParallelGrip' if cfg.gripper == 'parallel_jaw' else 'Robotiq85Grip'
    if render:
        eid += 'Render'
    eid += 'SparseReward' if cfg.binary_reward else 'DenseReward'
    if cfg.joint_control:
        eid += 'JointCtrl'
    if cfg.image_observation:
        eid += 'DepthImgObs' if cfg.depth_image else 'ImgObs'
        if cfg.goal_image:
            eid += 'ImgGoal'
    return eid + '-v0'
