"""Serving launcher: random weights from a seed, or with ``--ckpt-dir DIR``
the parameters of DIR's latest checkpoint (a training state written by
``launch/train.py --ckpt-dir DIR`` on one device or on any grid: its
``params/*``, each cast to ``--dtype``), then greedy requests through
the continuous-batching engine on ``--executor`` (``cuda``, the kernels,
by default; ``blocks``, the block schedule in plain PyTorch products; or
``dense``, every expert on every token: the paper's PyTorch baseline; the
reference's spellings ``pallas`` and ``xla`` name ``cuda`` and
``blocks``).  By default the
engine chooses its cache: paged (blocks of 16, chunked prefill, prefix
cache; ``--no-prefix-cache`` turns the last off) wherever every layer's
cache is positional KV, else contiguous; the schedule is ``dynamic``.
``--kv-block 0 --policy fixed`` gives the contiguous engine with the
paper's ``fixed`` schedule, ``--kv-block N`` the paged engine with blocks
of N (which refuses a model with recurrent layers: "non-pageable");
``--kv-block-size`` and ``--schedule-policy`` are the reference
launcher's spellings of the two.  ``--capacity`` sets a slot's tokens
(default: the longest prompt + ``--max-new`` + 1; less than the longest
prompt + ``--max-new`` is refused).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --layers 4 --requests 4 --max-new 16 \\
        --slots 2 --dtype bf16 --seed 0

Train, then serve what training wrote (here on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch moonshot-v1-16b-a3b --reduce --steps 4 \\
        --ckpt-dir build/ckpt_cpu --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --reduce --ckpt-dir build/ckpt_cpu \\
        --dtype fp32 --device cpu

``--arch deepseek-v2-236b`` serves the MLA model (latent KV cache; the
paged read runs the MLA form of the paged-attention kernel); ``--arch``
``qwen2-7b``, ``smollm-360m``, ``starcoder2-3b`` or ``gemma2-9b`` a dense
model (GQA; gemma2's local layers take its sliding window in contiguous
prefill, and its depth must be even: a local and a global layer a group).
``--arch rwkv6-1.6b`` (time-mix and channel-mix layers) and ``zamba2-7b``
(Mamba2 layers and shared attention blocks) serve a recurrent model on the
contiguous engine, each slot carrying its recurrent state.  Widths are the
architecture's own; ``--layers`` cuts depth (deepseek-v2 at 4 layers holds
13.3 B parameters, 26.6 GB in bf16; for zamba2 it counts the Mamba layers,
as ``n_layers`` does, at least 3), ``--reduce`` takes the reduced (smoke)
config as the reference's launcher does.  ``--quant
{none,int8_expert,int8_channel,int4_packed}`` serves the routed experts
compressed under that scheme (quantized at load, one stack at a time; the
kernels dequantize on chip); ``--quant-experts`` is its deprecated alias
for ``int8_expert``.  A dense model has no routed experts, and the flag
leaves it as it is, as in the reference.  Prints the routed experts'
stored bytes and the peak device memory from load to the end of serving.
Runs on the card; ``--device cpu`` runs the kernels' plain versions on the
CPU.

Scheduling and observability: ``--admission {fcfs,sjf,prefix_hit,slo}``
picks the pending request for each free slot (``slo`` admits by TTFT
deadline and preempts; ``--slo-ttft`` / ``--slo-tpot`` give every request
its deadlines in seconds), ``--max-steps`` bounds the run (unfinished
requests are reported).  Each request's plan stats (``sched/*`` of its
last step, summed over the MoE layers) are printed, then TTFT, TPOT,
queue wait and end-to-end latency (mean, p50, p99 over the completed
requests) and the paged cache's stats.  ``--trace [PATH]`` writes the
step timeline as a Chrome trace, ``--metrics-out [PATH]`` the metrics
snapshot with the latency table as JSON, ``--device-trace DIR`` a
``torch.profiler`` trace of the run (kernels and device times).

Sampling and speculation: ``--sampling {greedy,temperature,top_k,top_p}``
with ``--temperature``, ``--top-k``, ``--top-p`` draws each token under a
key of the request's seed (``--seed`` + rid: ``--seed`` also seeds the
weights and prompts), its output index and a role; ``--spec-draft ARCH``
serves speculatively (the paged engine only) with that draft (random
weights from ``--seed`` + 1, under ``--ckpt-dir`` too; the target's
vocabulary, reduced alongside ``--reduce``) proposing ``--spec-k`` tokens
a slot a round.  Front end:
``--stream`` serves through ``ServingFrontend`` and prints each token as
the step's transfer delivers it; ``--loadgen PATTERN`` (poisson, burst,
shared_prefix, longtail) replays a seeded arrival trace (24 requests at
8 req/s of virtual time, ``--smoke`` 12) through it on a virtual clock,
advanced 0.05 s a step or, with ``--calibrate``, by the measured step
time's EWMA, and writes the goodput record (with the paged cache's
stats) to ``results/serve/loadgen_<arch>[_smoke].json``; ``main`` returns
it with each request's tokens (``outputs``).

Expert parallelism: ``--distributed`` serves with every MoE layer's routed
experts split over the ranks of an EP group (``apply_moe_ep``; non-expert
weights whole on every rank), each rank running the same engine over the
same requests with per-host admission (``--hosts`` queues,
``DistributedServeLoop``).  With ``--num-processes N`` (and
``--coordinator host:port``, ``--process-id``; or torchrun's environment)
this process is one rank of N; with one process, ``--ep-devices N`` (2 by
default) spawns N ranks on ``--device``.  The backend is NCCL when each
rank has a card of its own (``--device cuda`` and enough cards), else gloo
(the CPU, or ranks sharing a card).  ``--ep-decode-layout
{replicated,sharded}`` is the token layout of every decode-mode forward:
on the paged engine that is every step, prompt chunks included (only the
contiguous engine's prefill forwards take ``sharded`` whatever it says);
``--ep-overlap`` pipelines the sharded dispatch in
``--ep-microbatches`` microbatches.  Only rank 0 prints; a rank's failure
fails the launch.  ``--executor dense`` has no phases to split over
ranks, and ``--distributed`` refuses it before anything is loaded.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --reduce --requests 3 --max-new 3 \\
        --distributed --ep-devices 2 --hosts 2 --device cpu"""
import argparse
import contextlib
import io
import json
import pathlib
import time

import numpy as np
import torch

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def parse_args(argv=None):
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.execution import available_executors, executor_cli_name
    from repro_torch.quantization import available_schemes
    from repro_torch.scheduling import available_policies
    from repro_torch.sampling import available_samplers
    from repro_torch.serve.admission import available_admission_policies
    from repro_torch.serve.loadgen import PATTERNS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut (default: the architecture's own)")
    ap.add_argument("--reduce", action="store_true",
                    help="use the reduced (smoke) config")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and prompts, and is the "
                         "sampling seed base: request i draws from stream "
                         "seed + i (stochastic methods only)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="serve the parameters of DIR's latest checkpoint "
                         "(a training state's params/*, cast to --dtype) "
                         "instead of random weights")
    ap.add_argument("--capacity", type=int, default=None,
                    help="per-slot KV capacity in tokens (default: the "
                         "longest prompt + --max-new + 1); a value below the "
                         "longest prompt + --max-new is refused")
    ap.add_argument("--kv-block", "--kv-block-size", dest="kv_block",
                    type=int, default=None,
                    help="KV block size of the paged engine; 0 = contiguous; "
                         "default: the engine's choice (blocks of 16 "
                         "wherever every layer's cache is positional KV, "
                         "else contiguous)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="share cached full prompt blocks across requests "
                         "(paged engine; default on)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--policy", "--schedule-policy", dest="policy",
                    default="dynamic", choices=available_policies(),
                    help="schedule policy")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per slot per paged step")
    ap.add_argument("--paged-attn", default="auto",
                    choices=("auto", "fused", "gather"),
                    help="paged read: fused kernel (auto on cuda) or "
                         "gather + attention")
    ap.add_argument("--quant", default=None, choices=available_schemes(),
                    help="expert-weight quantization scheme (default: none)")
    ap.add_argument("--executor", default="cuda", type=executor_cli_name,
                    choices=available_executors(),
                    help="MoE executor (repro_torch.execution registry; "
                         "the reference's pallas and xla name cuda and "
                         "blocks)")
    ap.add_argument("--autotune", action="store_true",
                    help="run B1/B2 at the tune cache's tile shapes and the "
                         "dynamic policy at its swept floor (the packaged "
                         "H100 cache overlaid by $REPRO_TORCH_TUNE_CACHE or "
                         "results/tuning/cache_torch.json) instead of the "
                         "default tiles")
    ap.add_argument("--quant-experts", action="store_true",
                    help="DEPRECATED: alias for --quant int8_expert")
    ap.add_argument("--admission", default="fcfs",
                    choices=available_admission_policies(),
                    help="which pending request gets a freed slot (fcfs, "
                         "sjf = shortest prompt, prefix_hit = warmest "
                         "cached prefix, slo = TTFT-deadline feasibility "
                         "with preemption)")
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="S",
                    help="per-request time-to-first-token deadline "
                         "(seconds); pair with --admission slo")
    ap.add_argument("--slo-tpot", type=float, default=None, metavar="S",
                    help="per-request time-per-output-token budget "
                         "(seconds); pair with --admission slo")
    ap.add_argument("--max-steps", type=int, default=512,
                    help="engine-step budget for the whole run; requests "
                         "still unfinished when it runs out are reported "
                         "(partial output kept)")
    ap.add_argument("--sampling", default="greedy",
                    choices=available_samplers(),
                    help="token pick: greedy (the argmax) or a keyed draw "
                         "on the device (one host transfer a step still)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k cut for --sampling top_k (0 = none)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass for --sampling top_p (1.0 = none)")
    ap.add_argument("--spec-draft", default=None, metavar="ARCH",
                    choices=ARCH_NAMES,
                    help="speculative decoding with this draft architecture "
                         "(e.g. smollm-360m; the target's vocabulary, reduced "
                         "alongside --reduce); paged engine only")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed a slot a round (the target "
                         "verifies k + 1 positions a slot in one forward)")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the open-stream front end and print "
                         "each token as the step's transfer delivers it")
    ap.add_argument("--loadgen", default=None, metavar="PATTERN",
                    choices=PATTERNS,
                    help="replay a seeded arrival trace on virtual time "
                         "through the front end; writes results/serve/"
                         "loadgen_<arch>[_smoke].json")
    ap.add_argument("--smoke", action="store_true",
                    help="with --loadgen: a 12-request trace")
    ap.add_argument("--calibrate", action="store_true",
                    help="with --loadgen: advance the virtual clock by the "
                         "measured step time's EWMA instead of 0.05 s")
    ap.add_argument("--trace", nargs="?", const="results/trace/serve.json",
                    default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the step timeline "
                         "(default path results/trace/serve.json)")
    ap.add_argument("--metrics-out", nargs="?",
                    const="results/serve/metrics.json", default=None,
                    metavar="PATH",
                    help="write the metrics snapshot (counters, gauges, "
                         "histograms, latency percentiles) as JSON")
    ap.add_argument("--device-trace", default=None, metavar="DIR",
                    help="bracket the run in a torch.profiler trace (CPU "
                         "and CUDA activity) written to DIR")
    ap.add_argument("--distributed", action="store_true",
                    help="expert-parallel serving: the routed experts split "
                         "over an EP group of ranks, per-host admission "
                         "queues, one engine a rank")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="with --num-processes > 1: the rendezvous address "
                         "(process 0 binds it)")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="ranks launched separately (this process is one); "
                         "1 spawns --ep-devices ranks from this process")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--hosts", type=int, default=None,
                    help="admission host-queue count (default: "
                         "--num-processes)")
    ap.add_argument("--ep-devices", type=int, default=None,
                    help="ranks of the EP group (default: all ranks; with "
                         "one process, 2 spawned ranks)")
    ap.add_argument("--ep-overlap", action="store_true",
                    help="pipeline the sharded EP dispatch (microbatch "
                         "i+1's all_to_all overlaps microbatch i's GEMMs)")
    ap.add_argument("--ep-microbatches", type=int, default=2)
    ap.add_argument("--ep-decode-layout", default="replicated",
                    choices=("replicated", "sharded"),
                    help="EP token layout of decode-mode forwards (every "
                         "step of the paged engine, prompt chunks too)")
    return ap.parse_args(argv)


def main(argv=None):
    """Serve; with ``--distributed``, on every rank of an EP group.
    Returns rank 0's completed requests (or the load generator's
    record)."""
    from repro_torch.distributed import (init_distributed, make_ep_group,
                                         spawn_ranks, use_ep_group)
    from repro_torch.execution import get_executor
    args = parse_args(argv)
    if not args.distributed:
        return serve(args, args.device)
    if not get_executor(args.executor).needs_schedule:
        raise SystemExit(f"--executor {args.executor} has no schedule to "
                         "split over EP ranks: --distributed runs on blocks "
                         "or cuda")
    if args.num_processes > 1:
        import torch.distributed as dist
        dev = init_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
        try:
            group = make_ep_group(args.ep_devices, device=dev)
            with use_ep_group(group):
                return serve_rank(group, args)
        finally:
            dist.destroy_process_group()
    return spawn_ranks(serve_rank, args.ep_devices or 2, args.device,
                       args)[0]


def serve_rank(group, args):
    """One rank of a ``--distributed`` launch: ranks other than 0 of the
    default group print nothing (their errors still reach stderr)."""
    import torch.distributed as dist
    quiet = (contextlib.redirect_stdout(io.StringIO())
             if dist.get_rank() != 0 else contextlib.nullcontext())
    with quiet:
        return serve(args, group.device, group)


def load_checkpoint(cfg, ckpt_dir: str, dtype, device):
    """The model of ``cfg`` at ``dtype`` holding the parameters of
    ``ckpt_dir``'s latest checkpoint (``params/*`` of a training state,
    written on one device or on any grid), each cast to its parameter's
    dtype.  The model is laid out on the meta device and allocated
    uninitialised on ``device``: no random draw.  Prints the step, the
    bytes read and the seconds."""
    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.lm import LM
    if not pathlib.Path(ckpt_dir).is_dir():
        raise SystemExit(f"--ckpt-dir {ckpt_dir}: no such directory")
    dev = resolve_device(device)
    model = LM(cfg, None, dtype, torch.device("meta")).to_empty(device=dev)
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    mgr.restore_params(model)
    st = mgr.stats
    print(f"checkpoint {ckpt_dir}: step {st['restore_step']}, "
          f"{st['restore_bytes']} bytes of params/* read in "
          f"{st['restore_s']:.3f} s, cast to {str(dtype).split('.')[-1]}")
    return model


def serve(args, device, group=None):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import RunConfig, init_params
    from repro_torch.quantization import resolve_quant_cli, routed_expert_bytes
    from repro_torch.obs import (NOOP, Observability, device_trace,
                                 drop_summary, latency_summary)
    from repro_torch.sampling import SamplingConfig
    from repro_torch.serve.distributed import DistributedServeLoop
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.frontend import ServingFrontend
    from repro_torch.serve.loadgen import (make_virtual_obs, replay,
                                           synth_trace)
    from repro_torch.spec import SpecEngine, make_draft_config

    quant = resolve_quant_cli(args.quant, args.quant_experts)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    if not cfg.is_moe:
        quant = "none"          # no routed experts to quantize
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    dt = DTYPES[args.dtype]
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, int(rng.integers(16, 65))).astype(np.int32),
                    max_new=args.max_new, slo_ttft=args.slo_ttft,
                    slo_tpot=args.slo_tpot)
            for i in range(args.requests)]
    prompts = [r.prompt for r in reqs]
    trace = None
    if args.loadgen:
        trace = synth_trace(args.loadgen, seed=0,
                            n=12 if args.smoke else 24, rate=8.0,
                            vocab=cfg.vocab_size, max_new=args.max_new,
                            slo_ttft=(0.4 if args.slo_ttft is None
                                      else args.slo_ttft),
                            slo_tpot=args.slo_tpot, burst_size=6,
                            prompt_hi=40)
        prompts = [e.prompt for e in trace]
    need = max(len(p) for p in prompts) + args.max_new
    capacity = need + 1 if args.capacity is None else args.capacity
    if capacity < need:
        raise SystemExit(f"--capacity {capacity} cannot hold the longest "
                         f"prompt and --max-new: {need} tokens a slot")
    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    if args.ckpt_dir:
        model = load_checkpoint(cfg, args.ckpt_dir, dt, device)
    else:
        model = init_params(cfg, args.seed, param_dtype=dt, device=device)
    dense_bytes = routed_expert_bytes(model)
    rc = RunConfig(compute_dtype=dt, executor=args.executor,
                   schedule_policy=args.policy,
                   paged_attn=args.paged_attn, quant=quant,
                   moe_stats=bool(cfg.is_moe), autotune=args.autotune,
                   ep=bool(args.distributed and cfg.is_moe),
                   ep_overlap=args.ep_overlap,
                   ep_microbatches=args.ep_microbatches,
                   ep_decode_layout=args.ep_decode_layout)
    clock = None
    if args.loadgen:
        clock, obs = make_virtual_obs(enabled=True)
    else:
        obs = (Observability.memory()
               if (args.trace or args.metrics_out or args.device_trace)
               else NOOP)
    sampling = SamplingConfig(method=args.sampling,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed)
    kw = dict(slots=args.slots, capacity=capacity, rc=rc,
              admission=args.admission, kv_block_size=args.kv_block,
              prefix_cache=args.prefix_cache,
              prefill_chunk=args.prefill_chunk, obs=obs, sampling=sampling,
              device=device)
    if args.spec_draft:
        dcfg = make_draft_config(cfg, args.spec_draft, reduce=args.reduce)
        dmodel = init_params(dcfg, args.seed + 1, param_dtype=dt,
                             device=device)
        engine = SpecEngine(cfg, model, draft_cfg=dcfg, draft_model=dmodel,
                            spec_k=args.spec_k, **kw)
        print(f"speculative decoding: draft {dcfg.name} ({dcfg.n_layers} "
              f"layers) proposes k={args.spec_k} tokens a slot a round; the "
              f"target verifies {args.spec_k + 1} positions a slot in one "
              "forward")
    else:
        engine = ServeEngine(cfg, model, **kw)
    from repro_torch.models.lm import RECURRENT_KINDS, layer_kinds
    kinds = layer_kinds(cfg)
    n_rec = sum(k in RECURRENT_KINDS for k in kinds)
    n_kv = len(kinds) - n_rec
    n_cross = kinds.count("cross")
    cache = (f"paged KV cache (blocks of {engine.kv_block_size}, prefill "
             f"chunks of {engine.prefill_chunk}, {args.paged_attn} read, "
             f"prefix cache {'on' if args.prefix_cache else 'off'})"
             if engine.paged else
             f"contiguous KV cache (and {n_cross} cross blocks' image K/V a "
             f"slot, from zero image embeddings)" if n_cross else
             "contiguous KV cache" if not n_rec else
             f"contiguous cache ({n_rec} recurrent states"
             + (f" and {n_kv} KV caches" if n_kv else "") + " a slot)")
    width = "reduced width" if args.reduce else "full width"
    print(f"{cfg.name}: {cfg.n_layers} layers at {width}, {args.dtype}, "
          f"{cache}, {args.policy} schedule, {args.executor} executor, "
          f"{args.admission} admission, {args.sampling} sampling, "
          f"{args.slots} slots x {capacity} tokens")
    n_hosts = args.hosts or max(1, args.num_processes)
    if group is not None:
        print(f"distributed serving: EP group of {group.size} ranks "
              f"({group.backend}), {n_hosts} host queue(s), decode layout "
              f"{args.ep_decode_layout}, overlap "
              + (f"on ({args.ep_microbatches} microbatches)"
                 if args.ep_overlap else "off")
              + ("" if cfg.is_moe else "; a dense model has no experts to "
                 "split: every rank serves it whole"))
    if cfg.is_moe:
        print(f"routed experts: {quant} scheme, "
              f"{routed_expert_bytes(model)} bytes stored ({dense_bytes} "
              f"dense {args.dtype})")
    if args.loadgen:
        rec = replay(engine, trace, clock=clock,
                     step_time=None if args.calibrate else 0.05, seed=0,
                     pattern=args.loadgen,
                     max_steps=min(args.max_steps, 1024))
        outputs = rec.pop("outputs", None)
        if engine.paged:
            rec["kv_stats"] = engine.kv.stats()
        out_path = pathlib.Path("results/serve")
        out_path.mkdir(parents=True, exist_ok=True)
        out_path = out_path / (f"loadgen_{args.arch}"
                               f"{'_smoke' if args.smoke else ''}.json")
        out_path.write_text(json.dumps(
            {"arch": args.arch, "reduced": args.reduce,
             "virtual_time": True, "step_time_mode": rec["step_time_mode"],
             "records": [rec]}, indent=1))
        print(f"loadgen {args.loadgen}: {rec['completed']}/"
              f"{rec['n_requests']} completed, goodput "
              f"{rec['goodput_rps']:.3f} req/s, attainment "
              f"{rec['slo_attainment']:.2f}, preempted {rec['preempted']}, "
              f"resumed {rec['resumed']}, TTFT p50 {rec['ttft_p50_s']} s, "
              f"step {rec['step_time_s']} s ({rec['step_time_mode']})")
        if engine.paged:
            print(f"paged-cache stats: {rec['kv_stats']}")
        print(f"loadgen record -> {out_path}")
        return dict(rec, outputs=outputs)
    bracket = (device_trace(args.device_trace) if args.device_trace
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with bracket:
        if args.stream:
            fe = ServingFrontend(engine)
            reqs = [fe.submit(r.prompt, max_new=r.max_new, rid=r.rid,
                              slo_ttft=r.slo_ttft, slo_tpot=r.slo_tpot,
                              on_token=lambda req, tok: print(
                                  f"  stream rid={req.rid} "
                                  f"tok[{len(req.out) - 1}]={tok}"))
                    for r in reqs]
            fe.drain(max_steps=args.max_steps)
            done = [r for r in reqs if r.done]
        elif group is not None:
            done = DistributedServeLoop(
                engine, n_hosts=n_hosts, admission=args.admission).run(
                reqs, max_steps=args.max_steps)
        else:
            done = engine.run(reqs, max_steps=args.max_steps)
    dt_s = time.perf_counter() - t0
    for r in reqs:
        tag = "" if r.done else "  [INCOMPLETE: step budget exhausted]"
        print(f"req {r.rid}: {len(r.prompt)} prompt tokens -> {r.out}{tag}")
        sched = {k.split("/", 1)[1]: round(v, 3)
                 for k, v in r.stats.items() if k.startswith("sched/")}
        if sched:
            print(f"  plan stats (last step, shared by "
                  f"{int(r.stats.get('serve/decode_batch', 1))} slot(s), "
                  f"summed over moe layers): {sched}")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"{len(done)}/{len(reqs)} requests completed, {n_tok} tokens, "
          f"{engine.n_forwards} forwards in {dt_s:.3f} s on "
          f"{engine.device}; {engine.n_preempted} preempted, "
          f"{engine.n_resumed} resumed")
    if isinstance(engine, SpecEngine):
        print(f"speculation: {engine.n_spec_rounds} rounds, "
              f"{engine.n_accepted}/{engine.n_drafted} drafts accepted "
              f"(rate {engine.acceptance_rate:.2f}); {engine.n_forwards} "
              f"target + {engine.n_draft_forwards} draft forwards")
    # completion percentiles over completed requests only: censored
    # (dropped or preempted) stats are rolled up by drop_summary
    lat = latency_summary([r for r in reqs if r.done])
    for fam in ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s"):
        agg = lat.get(fam)
        if agg:
            print(f"  {fam:>13}: mean {agg['mean'] * 1e3:8.2f} ms  "
                  f"p50 {agg['p50'] * 1e3:8.2f} ms  "
                  f"p99 {agg['p99'] * 1e3:8.2f} ms  (n={agg['n']})")
    if engine.paged:
        print(f"paged-cache stats: {engine.kv.stats()}")
    drops = drop_summary(reqs)
    if drops:
        wait = drops["wait_s"]
        tail = (f"; censored wait p50 {wait['p50'] * 1e3:.1f} ms"
                if wait else "")
        print(f"WARNING: {drops['n']} request(s) did not complete under "
              f"--max-steps={args.max_steps} "
              f"({drops['dropped']} dropped, {drops['preempted']} "
              f"preempted-unresumed; rids {drops['rids']}); "
              f"{drops['tokens_out']} partial token(s) retained on "
              f"Request.out{tail}")
    peak = (f"{torch.cuda.max_memory_allocated(engine.device)} bytes"
            if on_card else "not measured (no card)")
    print(f"peak device memory (load, quantization and serving): {peak}")
    if args.trace:
        path = engine.obs.tracer.save(args.trace)
        print(f"chrome trace ({len(engine.obs.tracer.events)} events) "
              f"-> {path}")
    if args.metrics_out:
        extra = {"latency": lat}
        if engine.paged:
            extra["kv_stats"] = engine.kv.stats()
        engine.obs.metrics.to_json(args.metrics_out, extra=extra)
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.device_trace:
        print(f"device trace -> {args.device_trace}/device_trace.json")
    return done


if __name__ == "__main__":
    main()
