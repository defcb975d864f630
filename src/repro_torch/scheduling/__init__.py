"""Schedule policies (counterpart of ``repro.scheduling``): the paper's
``fixed`` policy and the ``dynamic`` policy the serving engine defaults to."""
from repro_torch.scheduling.base import (BlockSchedule, available_policies,
                                         build_schedule,
                                         combine_scale_rows, get_policy,
                                         policy_config_kwargs,
                                         register_policy, round_up)
from repro_torch.scheduling import fixed  # noqa: F401  (registers "fixed")
from repro_torch.scheduling import dynamic  # noqa: F401  (registers "dynamic")
from repro_torch.scheduling.dynamic import build_dynamic_schedule, sub_block
from repro_torch.scheduling.fixed import build_fixed_schedule, schedule_capacity

__all__ = [
    "BlockSchedule", "available_policies", "build_schedule",
    "combine_scale_rows", "get_policy",
    "policy_config_kwargs", "register_policy", "round_up",
    "build_dynamic_schedule", "build_fixed_schedule", "schedule_capacity",
    "sub_block",
]
