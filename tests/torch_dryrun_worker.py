"""Rank body of tests/test_torch_dryrun.py's grid case: runs in each
spawned gloo rank, imports torch and the port only, and returns the
collectives, FLOPs and argument bytes of one real step of each case on a
2x2 grid (rank 0's; every rank runs the same collectives)."""
import contextlib

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.collectives import records_of
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.distributed import group as G
from repro_torch.launch.dryrun import argument_bytes
from repro_torch.launch.specs import cell_inputs


def rank_main(group, cases):
    grid = G.make_grid(2, 2, device="cpu", verbose=False)
    out = []
    for case in cases:
        cfg = reduced(get_config(case["arch"]), layers=case["layers"])
        ci = cell_inputs(case["arch"], ShapeConfig(**case["shape"]), grid,
                         cfg=cfg, accum=case.get("accum"))
        args, _, _ = argument_bytes(ci.arguments)
        G.reset_collectives()
        ep = (G.use_ep_group(grid.group("model")) if ci.rc.ep
              else contextlib.nullcontext())
        with ep, FlopCounterMode(display=False) as fc:
            ci.step_fn(*ci.args)
        out.append({"records": records_of(G.COLLECTIVE_GROUPS),
                    "flops": fc.get_total_flops(),
                    "argument_bytes": args["total"]})
        grid.world.barrier()
    return out if group.rank == 0 else None
