"""Schedule policies (counterpart of ``repro.scheduling``); the port has the
paper's ``fixed`` policy so far."""
from repro_torch.scheduling.base import (BlockSchedule, available_policies,
                                         build_schedule, get_policy,
                                         policy_config_kwargs,
                                         register_policy, round_up)
from repro_torch.scheduling import fixed  # noqa: F401  (registers "fixed")
from repro_torch.scheduling.fixed import build_fixed_schedule, schedule_capacity

__all__ = [
    "BlockSchedule", "available_policies", "build_schedule", "get_policy",
    "policy_config_kwargs", "register_policy", "round_up",
    "build_fixed_schedule", "schedule_capacity",
]
