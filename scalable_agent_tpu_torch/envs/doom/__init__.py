"""VizDoom environment family: copies of ``scalable_agent_tpu/envs/doom/``
(``tools.py``: the sample, replay and play CLI and ``concat_grid``).

The reference fork's distinguishing environment backend: IMPALA-on-VizDoom
(reference: environments_doom.py:33-97 and the vendored Sample-Factory
layer under envs/doom/).  Everything here is importable without the
``vizdoom`` pip package — the simulator loads lazily on first env
construction, so the rest of the framework (and the hermetic test suite,
which substitutes a fake ``vizdoom`` module) never needs it.
"""

from scalable_agent_tpu_torch.envs.doom.action_space import (
    doom_action_space,
    doom_action_space_basic,
    doom_action_space_continuous_no_weap,
    doom_action_space_discrete,
    doom_action_space_discrete_no_weap,
    doom_action_space_discretized,
    doom_action_space_discretized_no_weap,
    doom_action_space_full_discretized,
)
from scalable_agent_tpu_torch.envs.doom.specs import (
    DOOM_ENVS,
    DoomSpec,
    doom_spec_by_name,
)
from scalable_agent_tpu_torch.envs.doom.factory import make_doom_env
