"""Schedule policies (counterpart of ``repro.scheduling``): the paper's
``fixed`` policy, GShard-style ``capacity_factor`` and the ``dynamic``
policy the serving engine defaults to; ``schedule_stats`` telemetry."""
from repro_torch.scheduling.base import (DEFAULT_POLICY_SWEEP, BlockSchedule,
                                         ScheduleStats, available_policies,
                                         build_schedule,
                                         combine_scale_rows, get_policy,
                                         policy_config_kwargs,
                                         register_policy, round_up,
                                         schedule_stats)
from repro_torch.scheduling import fixed  # noqa: F401  (registers "fixed")
from repro_torch.scheduling import capacity  # noqa: F401  (registers "capacity_factor")
from repro_torch.scheduling import dynamic  # noqa: F401  (registers "dynamic")
from repro_torch.scheduling.capacity import (build_capacity_schedule,
                                             capacity_slots, expert_capacity)
from repro_torch.scheduling.dynamic import build_dynamic_schedule, sub_block
from repro_torch.scheduling.fixed import build_fixed_schedule, schedule_capacity

__all__ = [
    "DEFAULT_POLICY_SWEEP", "BlockSchedule", "ScheduleStats",
    "available_policies", "build_schedule", "combine_scale_rows",
    "get_policy", "policy_config_kwargs", "register_policy", "round_up",
    "schedule_stats", "build_capacity_schedule", "capacity_slots",
    "expert_capacity", "build_dynamic_schedule", "build_fixed_schedule",
    "schedule_capacity", "sub_block",
]
