"""Step demonstrator: sub-goal index scheduler for task decomposition.

The port's own copy of `pybullet_multigoal_gym_tpu/utils/demonstrator.py`
(plain Python, no arrays): cycles a demonstration (a list of sub-goal
indices), optionally sticks at the final goal, and supports resetting to the
demonstration whose final sub-goal matches a given index. Feed its indices
to `KukaMultiBlockEnv.set_sub_goal`."""


class StepDemonstrator:
    def __init__(self, demonstrations, stick_with_final_goal=True):
        self.demonstrations = demonstrations
        self.demon_num = len(demonstrations)
        self.demon_ind = 0
        self.current_goal = -1
        self.current_final_goal = 0
        self.stick_with_final_goal = stick_with_final_goal
        self.final = False

    def get_next_goal(self):
        demo = self.demonstrations[self.demon_ind]
        if self.stick_with_final_goal and self.current_goal != -1:
            self.final = False
            if demo[self.current_goal] == demo[-1]:
                self.final = True
                return demo[self.current_goal]
        self.current_goal = (self.current_goal + 1) % len(demo)
        return demo[self.current_goal]

    def manual_reset(self, demon_ind=None):
        if demon_ind is None:
            demon_ind = 0
        self.current_goal = -1
        self.demon_ind = demon_ind
        self.current_final_goal = self.demonstrations[self.demon_ind][-1]
        self.final = False

    def reset_with_the_last_sub_goal_index(self, ind):
        self.current_goal = -1
        for i in range(self.demon_num):
            if self.demonstrations[i][-1] == ind:
                self.demon_ind = i
                break
        self.current_final_goal = self.demonstrations[self.demon_ind][-1]
        self.final = False


def default_demonstrations(num_steps):
    """The per-env default: [[0], [0,1], ..., [0..n-1]]
    (`kuka_multi_step_base_env.py:116-119`)."""
    return [list(range(i + 1)) for i in range(num_steps)]
