"""MoE dispatch plan/execute split and executor registry (counterpart of
``repro.execution``); the port registers the ``cuda`` executor."""
from repro_torch.execution.base import (DispatchPlan, Executor,
                                        available_executors,
                                        combine_scale_rows, execute,
                                        get_executor, plan_dispatch,
                                        plan_schedule, register_executor,
                                        router_aux_losses, set_plan_hook)
from repro_torch.execution import cuda  # noqa: F401  (registers "cuda")

__all__ = [
    "DispatchPlan", "Executor", "available_executors", "combine_scale_rows",
    "execute", "get_executor", "plan_dispatch", "plan_schedule",
    "register_executor", "router_aux_losses", "set_plan_hook",
]
