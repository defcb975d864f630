"""Expert-parallel process groups (counterpart of the multi-process half of
``repro.launch.mesh``): ``init_distributed``, ``make_ep_group``,
``use_ep_group``, ``spawn_ranks``.  The EP MoE layer itself is
``repro_torch.core.distributed``."""
from repro_torch.distributed.group import (EPGroup, current_ep_group,
                                           free_port, init_distributed,
                                           make_ep_group, spawn_ranks,
                                           use_ep_group)

__all__ = ["EPGroup", "current_ep_group", "free_port", "init_distributed",
           "make_ep_group", "spawn_ranks", "use_ep_group"]
