"""Process groups (counterpart of the multi-process half of
``repro.launch.mesh``): ``init_distributed``, ``make_ep_group``,
``use_ep_group``, ``spawn_ranks`` and the grid of ranks ``make_grid``.
The EP MoE layer itself is ``repro_torch.core.distributed``; the partition
rules are ``distributed.sharding`` and the activation hooks
``distributed.ctx``."""
from repro_torch.distributed.group import (EPGroup, Grid, current_ep_group,
                                           free_port, init_distributed,
                                           make_ep_group, make_grid,
                                           spawn_ranks, use_ep_group)

__all__ = ["EPGroup", "Grid", "current_ep_group", "free_port",
           "init_distributed", "make_ep_group", "make_grid", "spawn_ranks",
           "use_ep_group"]
