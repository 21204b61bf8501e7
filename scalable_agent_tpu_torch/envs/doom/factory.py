"""Doom env construction entry point (registry target for ``doom_*``), a
copy of ``scalable_agent_tpu/envs/doom/factory.py``.

(reference: envs/doom/doom_utils.py:261-268 ``make_doom_env`` +
:220-258 multiplayer routing)
"""

from typing import Optional

from scalable_agent_tpu_torch.envs.doom.specs import (
    assemble_doom_env,
    doom_spec_by_name,
)


def make_doom_env(
    full_env_name: str,
    num_action_repeats: int = 4,
    width: int = 128,
    height: int = 72,
    num_agents: Optional[int] = None,
    num_bots: Optional[int] = None,
    num_humans: int = 0,
    **kwargs,
):
    """Build a Doom env by spec name.

    ``num_action_repeats`` maps onto VizDoom's native ``skip_frames``
    (the reference's cfg.env_frameskip).  Specs with multiple agents or
    bots route through the multiplayer layer: a UDP-networked game where
    player 0 hosts (reference: doom_utils.py:220-258).
    """
    spec = doom_spec_by_name(full_env_name)
    agents = spec.num_agents if num_agents is None else num_agents
    bots = spec.num_bots if num_bots is None else num_bots
    if agents > 1 or bots > 0:
        from scalable_agent_tpu_torch.envs.doom.multiplayer import (
            make_doom_multiplayer_env,
        )

        return make_doom_multiplayer_env(
            spec, skip_frames=num_action_repeats, width=width,
            height=height, num_agents=agents, num_bots=bots,
            num_humans=num_humans, **kwargs)
    return assemble_doom_env(
        spec, skip_frames=num_action_repeats, width=width, height=height,
        **kwargs)
