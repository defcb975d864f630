"""MoE dispatch plan/execute split and executor registry (counterpart of
``repro.execution``).  Importing the package registers the three
executors: ``cuda`` (the hand-written kernels, the default), ``blocks``
(the block schedule as a loop of plain PyTorch products, the counterpart
of the reference's ``xla``) and ``dense`` (every expert on every token,
the paper's PyTorch baseline)."""
from repro_torch.execution.base import (REFERENCE_SPELLINGS, DispatchPlan,
                                        Executor, available_executors,
                                        combine_scale_rows, execute,
                                        executor_cli_name, get_executor,
                                        plan_dispatch,
                                        plan_schedule, register_executor,
                                        router_aux_losses, set_plan_hook)
from repro_torch.execution import blocks, cuda, dense  # noqa: F401
from repro_torch.execution.blocks import (BlocksExecutor,
                                          fused_gate_up_blocks,
                                          grouped_gemm_blocks)
from repro_torch.execution.dense import DenseExecutor

__all__ = [
    "REFERENCE_SPELLINGS", "BlocksExecutor", "DenseExecutor",
    "DispatchPlan", "Executor", "available_executors", "combine_scale_rows",
    "execute", "executor_cli_name",
    "fused_gate_up_blocks", "get_executor", "grouped_gemm_blocks",
    "plan_dispatch", "plan_schedule", "register_executor",
    "router_aux_losses", "set_plan_hook",
]
