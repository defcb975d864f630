"""Language model for the ``moe`` family, with multi-head or latent (MLA)
attention, for the ``dense`` family, with global or alternating local and
global attention, for the recurrent ``ssm`` (rwkv6) and ``hybrid``
(zamba2: Mamba2 layers and shared attention blocks) families, for the
``vlm`` family (llama-3.2-vision: attention blocks with a cross-attention
block to image embeddings in each group) and for the ``audio`` encoder
(hubert: bidirectional attention over feature frames, no token embedding)
(counterpart of ``repro.models.lm``): the served path (prefill and decode
over a contiguous cache, and decode rows over a paged KV block pool) and,
for every family but the recurrent ones, the training path (``train``
mode, ``chunked_ce``, ``loss_fn``: next-token CE, or for the encoder CE
over the masked frames).

The reference stacks its body layers and scans them (``lax.scan``); here
the model is an ``nn.Module`` with an ``nn.ModuleList`` of layers in the
order of ``group_structure``: ``first_dense_layers`` dense-FFN blocks
(``moe_dense``) then MoE blocks (``moe``); or ``attn`` blocks; or, for
gemma2's ``local_global`` pattern, ``attn_local`` and ``attn_global`` in
turn; or the vlm's groups of ``cross_attn_every`` blocks, ``attn`` but for
a ``cross`` block second from the end of each; or ``rwkv`` blocks
(time-mix and channel-mix); or zamba2's groups of
a ``shared_attn`` block and ``attn_every`` ``mamba`` blocks, then a last
``shared_attn`` block and the remaining ``mamba`` ones.  A group's
``shared_attn`` entry is ``LM.shared[g % n_shared_attn_blocks]``, the same
module in every group that takes it, so its parameters exist once (as
``shared.<j>.*``); the last one is a block of its own, as in the
reference, which builds it apart from ``shared`` (ROADMAP C11).  The
reference also builds an attention block in every group's ``body.b0``
slot that its forward never reads; the port does not build those.  Every
``(in, out)`` matrix keeps the reference's layout.  Prefill and
training run the chunked ``flash_attention`` (``RunConfig.q_chunk`` /
``kv_chunk``), with the sliding window on ``attn_local`` layers, and MLA's
decompressed attention in the same chunks; decode runs one chunk and, as
the reference, no window (ROADMAP C1).  A ``cross`` block's queries come
from the residual and its keys and values from ``batch["image_embeds"]``
(no RoPE, no causal mask); prefill writes the image's K/V into the
block's cache and decode reads them there in one chunk.

The cache is a list with one flat dict per entry of ``layer_kinds``: a
``{"k", "v"}`` pair of (slots, capacity, Hkv, D) tensors for an attention
block (each application of a shared block has its own), or with MLA a
``{"ckv", "kr"}`` pair of (slots, capacity, kv_lora_rank) and (slots,
capacity, qk_rope_head_dim) latent rows; an ``rwkv`` block's
``{"tm_shift", "tm_state", "cm_shift"}`` and a ``mamba`` block's
``{"conv", "state"}`` (the states fp32), whose rows no position masks; a
``cross`` block's ``{"k", "v"}`` of (slots, n_image_tokens, Hkv, D), the
image's K/V, which no position masks either.
Every leaf has the slot on axis 0, so the slot helpers and the engine's
zeroing of a slot reach every leaf alike.  The cache is updated in place
(the reference returns a new cache; the port writes the rows it changes,
which saves a copy of the cache per step).  The paged pool
(``serve/kv_cache.py``) has the KV form with (n_blocks, block_size) in
place of (slots, capacity); the recurrent and ``cross`` kinds have no
pageable cache.

Every family trains, on one device and on a grid of ranks (inside
``distributed.ctx.use_rules``).  The grid's transformer rules cut each
sequence over 'model' (sequence parallelism: a layer gathers K and V);
the recurrent families' rules keep whole sequences on every 'model' rank
and split the heads of the WKV recurrence, the SSD scan and the shared
attention blocks over it instead (tensor-parallel heads,
``distributed/ctx.py``), and ``loss_fn`` counts the tokens those ranks
share once.  Prefill and decode run outside the grid's rules (across
ranks only through ``rc.ep``); the encoder has no prefill or decode."""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import apply_moe_ep, apply_moe_ep_local
from repro_torch.core.moe_layer import apply_moe, dispatch_config
from repro_torch.distributed.ctx import (block_offset, constrain,
                                         current_rules, global_sum,
                                         head_slice, head_sum, token_ids,
                                         token_replicas)
from repro_torch.distributed.sharding import gather_param, gather_spec
from repro_torch.execution import get_executor
from repro_torch.kernels.paged_attention import fused_read_refusal
from repro_torch.models.attention import (Attention, flash_attention,
                                          head_part, paged_decode,
                                          project_qkv, write_decode_rows)
from repro_torch.models.blocks import (dense_init, make_norm, normal_init,
                                       rope, softcap)
from repro_torch.models.ffn import FFN
from repro_torch.models.mla import MLA, mla_block, prefill_mla_cache
from repro_torch.models.rwkv6 import (ChannelMix, TimeMix, channel_mix,
                                      init_rwkv_cache, time_mix)
from repro_torch.models.ssm import Mamba2, init_ssm_cache, ssm_block
from repro_torch.quantization import EXPERT_MATS, QuantTensor
from repro_torch.scheduling import ScheduleStats


class RunConfig(NamedTuple):
    """Execution options orthogonal to the architecture.  The port's
    defaults are the ``cuda`` executor and the paper's ``fixed`` schedule
    (the serving engine defaults to ``dynamic``)."""
    compute_dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32   # master weights: fp32 only
    executor: str = "cuda"           # cuda | blocks | dense
                                     # (repro_torch.execution registry)
    schedule_policy: str = "fixed"   # fixed | capacity_factor | dynamic
    capacity_factor: float = 2.0     # the capacity_factor policy's headroom
    fuse_gate_up: bool = True
    fold_combine: bool = True
    block_m_min: int = 8             # the dynamic policy's sub-block floor
    q_chunk: int = 512               # flash_attention's query and KV
    kv_chunk: int = 512              # chunks in prefill and train (0 = one
                                     # chunk); decode runs one chunk
    loss_chunk: int = 1024           # chunked_ce's chunk length (train)
    remat: bool = False              # train: recompute each layer in the
                                     # backward (torch.utils.checkpoint)
    moe_stats: bool = False          # sched/* ScheduleStats in the aux
                                     # (executors with a schedule only)
    quant: str = "none"              # expert-weight QuantScheme for serving
                                     # (repro_torch.quantization registry;
                                     # the engine quantizes at load)
    autotune: bool = False           # B1/B2 tile shapes and the dynamic
                                     # floor from the tune cache
                                     # (repro_torch.tuning), per shape key
    paged_attn: str = "auto"         # paged decode read path:
                                     # auto   = fused kernel iff the executor
                                     #          is cuda (which raises on a
                                     #          pool shape it refuses),
                                     #          else gather
                                     # fused  = the paged-attention kernel
                                     # gather = gather_block_kv + attention
                                     #          (the oracle)
    ep: bool = False                 # expert parallelism: MoE layers run
                                     # apply_moe_ep over the current EP
                                     # group (repro_torch.distributed)
    ep_overlap: bool = False         # pipeline the sharded EP dispatch:
                                     # microbatch i+1's all_to_all is issued
                                     # before microbatch i's GEMMs
    ep_microbatches: int = 2         # microbatches under ep_overlap (the
                                     # largest divisor of T_local <= it)
    ep_decode_layout: str = "replicated"  # EP layout of decode-mode
                                     # forwards (every paged step, prompt
                                     # chunks too; prefill takes sharded):
                                     # replicated (all_reduce combine) or
                                     # sharded (padding-free all_to_all)


RECURRENT_FAMILIES = ("ssm", "hybrid")
RECURRENT_KINDS = ("rwkv", "mamba")
FAMILIES = ("moe", "dense", "vlm", "audio", *RECURRENT_FAMILIES)


def group_structure(cfg: ModelConfig):
    """-> (prefix_kinds, body_kinds, n_groups, suffix_kinds), the
    reference's: ``moe`` (with or without MLA; prefix ``moe_dense``, body
    ``moe``), ``dense`` and ``audio`` (body ``attn``, or ``attn_local``,
    ``attn_global`` for the ``local_global`` pattern, a group of two
    layers: an odd depth raises, where the reference would drop the last
    layer), ``vlm`` (body ``attn`` x ``cross_attn_every`` with ``cross`` in
    the second place from the end, n_layers // cross_attn_every groups: a
    depth that is not a whole number of groups raises, where the reference
    would drop the rest), ``ssm`` (body ``rwkv``) and ``hybrid`` (body
    ``shared_attn`` + ``mamba`` x ``attn_every``, (n_layers - 3) //
    attn_every groups, suffix ``shared_attn`` + the remaining ``mamba``:
    ``n_layers`` counts the Mamba layers, at least 3)."""
    L = cfg.n_layers
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"port builds {', '.join(FAMILIES)}")
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        if per < 2 or L % per:
            raise ValueError(
                f"{cfg.name} runs groups of cross_attn_every={per} layers "
                f"(at least 2), a cross block second from the end of each: "
                f"n_layers must be a multiple of it, not {L}")
        body = ["attn"] * per
        body[per - 2] = "cross"
        return [], body, L // per, []
    if cfg.family == "hybrid":
        per = cfg.attn_every
        if L < 3:
            raise ValueError(f"{cfg.name} ends in a shared_attn block and "
                             f"3 mamba layers or more: n_layers (the Mamba "
                             f"layers) must be >= 3, not {L}")
        n_groups = (L - 3) // per
        rem = L - n_groups * per
        return ([], ["shared_attn"] + ["mamba"] * per, n_groups,
                ["shared_attn"] + ["mamba"] * rem)
    if cfg.family == "ssm":
        return [], ["rwkv"], L, []
    if cfg.layer_pattern == "local_global":
        if L % 2:
            raise ValueError(
                f"{cfg.name} alternates local and global attention in groups "
                f"of two layers (attn_local, attn_global): n_layers must be "
                f"even, not {L}")
        return [], ["attn_local", "attn_global"], L // 2, []
    if cfg.is_moe:
        nd = cfg.moe.first_dense_layers
        return ["moe_dense"] * nd, ["moe"], L - nd, []
    return [], ["attn"], L, []


def layer_kinds(cfg: ModelConfig) -> list:
    """Every layer's block kind, in order."""
    prefix, body, n_groups, suffix = group_structure(cfg)
    return prefix + body * n_groups + suffix


class SharedExperts(nn.Module):
    def __init__(self, d: int, fs: int, gen, dtype, device):
        super().__init__()
        self.w_gate = normal_init(gen, (d, fs), d ** -0.5, dtype, device)
        self.w_up = normal_init(gen, (d, fs), d ** -0.5, dtype, device)
        self.w_down = normal_init(gen, (fs, d), fs ** -0.5, dtype, device)


class MoE(nn.Module):
    """Routed experts (E, in, out) stacks, an fp32 router and the optional
    shared experts.

    A routed stack is a parameter while dense.  ``set_expert_weight``
    replaces it with a ``QuantTensor``: the parameter is dropped, the
    payload and scales become the buffers ``<name>_q`` and ``<name>_s`` (so
    ``.to()`` and ``state_dict`` see them), and ``expert_weight`` rebuilds
    the ``QuantTensor`` around the current buffers."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        moe, d = cfg.moe, cfg.d_model
        E, f = moe.n_experts, moe.d_ff_expert
        s = d ** -0.5
        self.router = normal_init(gen, (d, E), s, torch.float32, device)
        self.w_gate = normal_init(gen, (E, d, f), s, dtype, device)
        self.w_up = normal_init(gen, (E, d, f), s, dtype, device)
        self.w_down = normal_init(gen, (E, f, d), f ** -0.5, dtype, device)
        self.shared = (SharedExperts(d, moe.n_shared_experts * f, gen, dtype,
                                     device)
                       if moe.n_shared_experts else None)
        self._quant: dict = {}       # name -> (dtype, scheme, meta)
        self.ep_shard = None         # (rank, ep) once shard_model ran

    def expert_weight(self, name: str):
        """The routed stack ``name``: a dense parameter or a QuantTensor."""
        if name in self._quant:
            dtype, scheme, meta = self._quant[name]
            return QuantTensor(getattr(self, f"{name}_q"),
                               getattr(self, f"{name}_s"), dtype, scheme,
                               meta)
        return getattr(self, name)

    def set_expert_weight(self, name: str, qt: QuantTensor) -> None:
        """Store the routed stack ``name`` as ``qt``; the dense parameter is
        released."""
        self._parameters.pop(name, None)
        self.register_buffer(f"{name}_q", qt.q)
        self.register_buffer(f"{name}_s", qt.s)
        self._quant[name] = (qt.dtype, qt.scheme, qt.meta)

    def params(self) -> dict:
        p = {"router": self.router}
        p.update({name: self.expert_weight(name) for name in EXPERT_MATS})
        if self.shared is not None:
            sh = self.shared
            p["shared"] = {"w_gate": sh.w_gate, "w_up": sh.w_up,
                           "w_down": sh.w_down}
        return p


class Block(nn.Module):
    """The reference's ``init_block`` leaves: for an attention-style kind
    (``cross`` included, whose leaves are an ``attn`` block's) ``norm1``,
    ``norm2`` (and with ``post_block_norm`` ``post_norm1``,
    ``post_norm2``) of ``cfg.norm``, ``attn`` (multi-head with the QKV
    biases, or MLA) and ``moe`` or ``ffn``; for ``rwkv`` ``norm1``,
    ``norm2``, ``tm`` (``TimeMix``) and ``cm`` (``ChannelMix``); for
    ``mamba`` ``norm1`` and ``ssm`` (``Mamba2``)."""

    def __init__(self, cfg: ModelConfig, kind: str, gen, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.norm1 = make_norm(cfg.norm, d, device)
        if kind == "mamba":
            self.ssm = Mamba2(d, cfg.ssm, gen, dtype, device)
            return
        self.norm2 = make_norm(cfg.norm, d, device)
        if kind == "rwkv":
            self.tm = TimeMix(d, cfg.rwkv, gen, dtype, device)
            self.cm = ChannelMix(d, cfg.d_ff, gen, dtype, device)
            return
        if cfg.post_block_norm:
            self.post_norm1 = make_norm(cfg.norm, d, device)
            self.post_norm2 = make_norm(cfg.norm, d, device)
        self.attn = (MLA(d, cfg.n_heads, cfg.mla, gen, dtype, device)
                     if cfg.mla is not None else
                     Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               gen, dtype, device, bias=cfg.qkv_bias))
        if kind == "moe":
            self.moe = MoE(cfg, gen, dtype, device)
        else:
            f = (cfg.moe.d_ff_dense or 4 * d) if kind == "moe_dense" \
                else cfg.d_ff
            self.ffn = FFN(d, f, cfg.act, cfg.mlp_bias, gen, dtype, device)

    def forward(self, x, cfg, rc, positions, mode: str = "train",
                image_embeds=None):
        """``apply_block`` on this block (so that ``torch.func.
        functional_call`` can run it on gathered weights)."""
        return apply_block(self, x, cfg, rc, positions=positions, mode=mode,
                           image_embeds=image_embeds)


class LM(nn.Module):
    """Embedding, layers, final norm and, unless ``tie_embeddings``, a
    ``head``: a tied model reads ``embed.T`` (``head_matrix``).  An
    ``encoder_only`` model has no token embedding: it holds ``mask_emb``,
    the (d,) vector that replaces a masked frame's features.  The ``ssm``
    family adds ``ln0`` after the embedding; the ``hybrid`` family holds
    its ``n_shared_attn_blocks`` shared blocks in ``shared`` (registered
    before ``layers``, so ``named_parameters`` names them ``shared.<j>``),
    and each group's ``shared_attn`` entry of ``layers`` is one of them."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        d = cfg.d_model
        prefix, body, n_groups, suffix = group_structure(cfg)  # raises first
        if cfg.encoder_only:
            self.mask_emb = normal_init(gen, (d,), 0.02, dtype, device)
        else:
            self.embed = normal_init(gen, (cfg.vocab_size, d), 0.02, dtype,
                                     device)
        if not cfg.tie_embeddings:
            self.head = dense_init(gen, (d, cfg.vocab_size), dtype, device)
        self.final_norm = make_norm(cfg.norm, d, device)
        if cfg.family == "ssm":
            self.ln0 = make_norm(cfg.norm, d, device)
        if cfg.family == "hybrid":
            self.shared = nn.ModuleList(
                [Block(cfg, "shared_attn", gen, dtype, device)
                 for _ in range(cfg.n_shared_attn_blocks)])

        def block(kind: str, group: Optional[int] = None) -> Block:
            if kind == "shared_attn" and group is not None:
                return self.shared[group % cfg.n_shared_attn_blocks]
            return Block(cfg, kind, gen, dtype, device)
        self.layers = nn.ModuleList(
            [block(k) for k in prefix]
            + [block(k, g) for g in range(n_groups) for k in body]
            + [block(k) for k in suffix])


def full_param(model: LM, cfg: ModelConfig, name: str,
               dt=None) -> torch.Tensor:
    """Parameter ``name`` (as ``named_parameters`` names it) whole: itself,
    or on a model sharded over a grid (``weights.shard_train_state``,
    inside ``distributed.ctx.use_rules``) gathered from every rank's
    block, in ``dt`` unless its consumer computes in fp32 (differentiable:
    the backward reduce-scatters).  A parameter whose spec gathers nothing
    (the vectors, fp32) comes as it is stored: its consumer casts it where
    the one-device path does."""
    p = model.get_parameter(name)
    specs = getattr(model, "shard_specs", None)
    if specs is None:
        return p
    _, grid = current_rules()
    if grid is None:
        raise RuntimeError(f"{name} is this rank's block of a sharded "
                           f"model: run it inside distributed.ctx.use_rules")
    spec = gather_spec(specs[name], model.full_shapes[name], cfg)
    # the MoE shared experts compute in fp32 from fp32 weights, and a
    # vector that nothing gathers passes as it is stored
    if dt is None or ".shared." in name or all(ax is None for ax in spec):
        dt = p.dtype
    return gather_param(p, spec, grid, dt)


def head_matrix(model: LM, cfg: ModelConfig, dt=None) -> torch.Tensor:
    """The (d, V) output projection: ``embed.T`` where the config ties it,
    else ``head`` (whole, in ``dt`` when sharded: ``full_param``)."""
    if cfg.tie_embeddings:
        return full_param(model, cfg, "embed", dt).t()
    return full_param(model, cfg, "head", dt)


def embed_inputs(model: LM, cfg: ModelConfig, batch: dict, dt
                 ) -> torch.Tensor:
    """The first residual in ``dt``: an encoder's ``batch["features"]``
    (B, S, d), with ``mask_emb`` in place of each frame where
    ``batch["mask"]`` is set; else the embedding of ``batch["tokens"]``."""
    if not cfg.encoder_only:
        return embed_tokens(model, cfg, batch["tokens"], dt)
    x = batch["features"].to(dt)
    if "mask" in batch:
        x = torch.where(batch["mask"][..., None], model.mask_emb.to(dt), x)
    return x


def embed_tokens(model: LM, cfg: ModelConfig, tokens: torch.Tensor, dt
                 ) -> torch.Tensor:
    """Token embeddings in ``dt``; with ``emb_scale`` times sqrt(d_model)
    rounded to ``dt`` first, as the reference's ``asarray(d ** 0.5, dt)``
    (60.0 for gemma2's 3584 in bf16)."""
    x = full_param(model, cfg, "embed", dt)[tokens].to(dt)
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    return x


def init_params(cfg: ModelConfig, seed: int = 0, *,
                param_dtype: torch.dtype = torch.float32,
                device="cuda") -> LM:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (reference scales; the reference's JAX draws are not reproduced: tests
    carry JAX weights over with ``repro_torch.weights.from_jax_params``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return LM(cfg, gen, param_dtype, dev)


# ----------------------------------------------------------------------
# Cache
# ----------------------------------------------------------------------
def _block_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int,
                 dtype, dev) -> dict:
    if kind == "rwkv":
        return init_rwkv_cache(batch, cfg.d_model, cfg.rwkv, dtype, dev)
    if kind == "mamba":
        return init_ssm_cache(batch, cfg.d_model, cfg.ssm, dtype, dev)
    if kind == "cross":              # the image's K/V, written at prefill
        shape = (batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.mla is not None:
        shapes = {"ckv": (batch, capacity, cfg.mla.kv_lora_rank),
                  "kr": (batch, capacity, cfg.mla.qk_rope_head_dim)}
    else:
        shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"k": shape, "v": shape}
    return {key: torch.zeros(shape, dtype=dtype, device=dev)
            for key, shape in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.float32, device="cuda") -> List[dict]:
    """One flat dict of zeros per entry of ``layer_kinds`` (the module
    docstring gives each kind's keys); ``capacity`` sizes the KV rows."""
    dev = resolve_device(device)
    return [_block_cache(cfg, kind, batch, capacity, dtype, dev)
            for kind in layer_kinds(cfg)]


def slice_cache_slots(cache, start: int, n: int):
    """Views of ``n`` consecutive slot rows; writes through them land in
    the full cache."""
    return [{k: t.narrow(0, start, n) for k, t in layer.items()}
            for layer in cache]


def update_cache_slots(cache, sub, start: int):
    """Write an n-slot sub-cache back into the full cache at ``start`` (a
    no-op for the views ``slice_cache_slots`` hands out)."""
    for layer, sl in zip(cache, sub):
        for k, t in layer.items():
            dst = t.narrow(0, start, sl[k].shape[0])
            if dst.data_ptr() != sl[k].data_ptr():
                dst.copy_(sl[k])
    return cache


def swap_cache_slots(cache, i: int, j: int):
    """Exchange two slot rows in place (engine compaction)."""
    for layer in cache:
        for t in layer.values():
            tmp = t[i].clone()
            t[i] = t[j]
            t[j] = tmp
    return cache


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def paged_fused(rc: RunConfig, pool: Optional[dict] = None) -> bool:
    """Whether the paged read runs the fused kernel (``rc.paged_attn``):
    ``auto`` runs it on the ``cuda`` executor and the gather elsewhere.
    Where its kernels refuse the block pool's shapes (``pool``: one layer's
    ``{"k", "v"}`` or MLA's ``{"ckv", "kr"}``), ``auto`` on ``cuda`` raises
    before the step, naming the shape; ``fused`` raises in the kernel's
    wrapper.  Neither falls back to the gather."""
    if rc.paged_attn not in ("auto", "fused", "gather"):
        raise ValueError(f"RunConfig.paged_attn={rc.paged_attn!r}; "
                         "expected auto | fused | gather")
    if rc.paged_attn != "auto":
        return rc.paged_attn == "fused"
    if rc.executor != "cuda":
        return False
    if pool is not None:
        if "ckv" in pool:
            ckv, kr = pool["ckv"], pool["kr"]
            refusal = fused_read_refusal(ckv.shape[1], ckv.shape[2],
                                         ckv.shape[2], ckv.element_size(),
                                         D2=kr.shape[2])
        else:
            k, v = pool["k"], pool["v"]
            refusal = fused_read_refusal(k.shape[1], k.shape[3], v.shape[3],
                                         k.element_size())
        if refusal is not None:
            raise ValueError(f"paged_attn='auto' reads the pool with the "
                             f"fused kernels on the cuda executor, and "
                             f"{refusal}; serve this pool with "
                             f"paged_attn='gather'")
    return True


def moe_stats_active(rc: RunConfig) -> bool:
    """Plan telemetry (``sched/*``) flows only where a schedule exists:
    ``rc.moe_stats`` on an executor that builds one (the ``dense`` oracle
    has none), as the reference's ``_moe_stats_active``."""
    return rc.moe_stats and get_executor(rc.executor).needs_schedule


def apply_block(blk: Block, x: torch.Tensor, cfg: ModelConfig, rc: RunConfig,
                *, positions, mode: str, cache=None, cache_pos=None,
                block_tables=None, fused: bool = False, image_embeds=None):
    """Returns (x, aux).  Writes the block's K/V (or MLA latent) rows into
    ``cache`` in place (prefill: rows [0, S); decode: row ``cache_pos[b]``
    of slot b, or with ``block_tables`` position ``cache_pos[b]`` of row
    b's blocks in the pool, read by the fused kernel when ``fused``).  An
    ``rwkv`` or ``mamba`` block carries its state in ``cache`` (written in
    place) and takes no positions.  A ``cross`` block attends to
    ``image_embeds`` (B, n_image_tokens, d) in train and prefill and to its
    cached image K/V in decode."""
    if blk.kind in RECURRENT_KINDS:
        return _recurrent_block(blk, x, cfg, cache), {}
    dt = x.dtype
    h = blk.norm1(x)
    if blk.kind == "cross":
        o = _cross_attention(blk.attn, h, image_embeds, cfg, rc, mode=mode,
                             cache=cache)
    elif cfg.mla is not None:
        o = _mla_attention(blk.attn, h, cfg, rc, positions=positions,
                           mode=mode, cache=cache, cache_pos=cache_pos,
                           block_tables=block_tables, fused=fused)
    else:
        window = cfg.local_window if blk.kind == "attn_local" else None
        o = _attention(blk.attn, h, cfg, rc, window=window,
                       positions=positions, mode=mode, cache=cache,
                       cache_pos=cache_pos, block_tables=block_tables,
                       fused=fused)
    if cfg.post_block_norm:
        o = blk.post_norm1(o)
    x = x + o.to(dt)

    h = blk.norm2(x)
    aux = {}
    if blk.kind == "moe":
        dcfg = dispatch_config(cfg.moe, executor=rc.executor,
                               fuse_gate_up=rc.fuse_gate_up,
                               fold_combine=rc.fold_combine,
                               schedule_policy=rc.schedule_policy,
                               capacity_factor=rc.capacity_factor,
                               block_m_min=rc.block_m_min,
                               emit_stats=moe_stats_active(rc),
                               autotune=rc.autotune)
        _, grid = current_rules()
        if grid is not None and grid.world.size > 1:
            # a grid's train path: this rank's tokens, EP over 'model', the
            # router losses and the capacity drops over the whole batch
            o, aux = apply_moe_ep_local(
                blk.moe.params(), h, dcfg,
                gtok=token_ids(h.shape[0], h.shape[1], h.device),
                group=grid.group("model"), token_group=grid.world,
                capacity_factor=rc.capacity_factor,
                overlap=rc.ep_microbatches if rc.ep_overlap else 0)
        elif rc.ep:
            o, aux = apply_moe_ep(
                blk.moe.params(), h, dcfg,
                capacity_factor=rc.capacity_factor,
                token_layout=(rc.ep_decode_layout if mode == "decode"
                              else "sharded"),
                overlap=rc.ep_microbatches if rc.ep_overlap else 0)
        else:
            o, aux = apply_moe(blk.moe.params(), h, dcfg)
    else:
        o = blk.ffn(h)
    if cfg.post_block_norm:
        o = blk.post_norm2(o)
    return x + o.to(dt), aux


def _recurrent_block(blk: Block, x: torch.Tensor, cfg: ModelConfig,
                     cache: Optional[dict]) -> torch.Tensor:
    """The reference's ``rwkv`` (time-mix, then channel-mix) and ``mamba``
    branches of ``apply_block``; the new state goes into ``cache`` in
    place, through whatever slot view the caller holds."""
    dt = x.dtype
    if blk.kind == "rwkv":
        tm = cm = None
        if cache is not None:
            tm = {"shift": cache["tm_shift"], "state": cache["tm_state"]}
            cm = {"shift": cache["cm_shift"]}
        o, tm = time_mix(blk.tm, blk.norm1(x), cfg.rwkv, cache=tm)
        x = x + o.to(dt)
        o, cm = channel_mix(blk.cm, blk.norm2(x), cache=cm)
        x = x + o.to(dt)
        new = (None if cache is None else
               {"tm_shift": tm["shift"], "tm_state": tm["state"],
                "cm_shift": cm["shift"]})
    else:
        o, new = ssm_block(blk.ssm, blk.norm1(x), cfg.ssm, cache=cache)
        x = x + o.to(dt)
    if cache is not None:
        for key, t in new.items():
            cache[key].copy_(t)
    return x


ONE_CHUNK = 10 ** 9          # a chunk length that covers any sequence


def _cross_attention(p: Attention, h: torch.Tensor, image_embeds,
                     cfg: ModelConfig, rc: RunConfig, *, mode: str,
                     cache) -> torch.Tensor:
    """Cross-attention sub-block (the reference's ``cross`` branch of
    ``apply_block``), output projection included.  Train and prefill:
    queries from ``h``, keys and values from ``image_embeds`` cast to h's
    dtype, no RoPE and no causal mask, ``flash_attention`` in ``rc``'s
    chunks with the config's logit softcap; prefill then writes the
    image's K/V into ``cache``.  Decode (``_cross_decode``): the queries
    alone, over the cached image K/V in one chunk, with no softcap and no
    ``kv_limit``; it writes nothing."""
    dt = h.dtype
    B, S, _ = h.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if mode == "decode":
        q = torch.matmul(h, p.wq.to(dt))
        if hasattr(p, "bq"):
            q = q + p.bq.to(dt)
        o = flash_attention(q.reshape(B, S, H, D), cache["k"].to(dt),
                            cache["v"].to(dt), causal=False,
                            q_chunk=ONE_CHUNK, kv_chunk=ONE_CHUNK)
    else:
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: a cross block attends to "
                             "batch['image_embeds'] (B, n_image_tokens, "
                             "d_model), which the batch lacks")
        q, k, v = project_qkv(p, h, H, Hkv, D, xkv=image_embeds.to(dt))
        o = flash_attention(q, k, v, causal=False,
                            logit_softcap=cfg.attn_logit_softcap,
                            q_chunk=rc.q_chunk or ONE_CHUNK,
                            kv_chunk=rc.kv_chunk or ONE_CHUNK)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    return torch.matmul(o.reshape(B, S, -1), p.wo.to(dt))


def _attention(p: Attention, h: torch.Tensor, cfg: ModelConfig,
               rc: RunConfig, *, window: Optional[int], positions, mode: str,
               cache, cache_pos, block_tables, fused: bool) -> torch.Tensor:
    """Multi-head attention sub-block, output projection included.  Prefill
    and train: ``flash_attention`` in ``rc``'s chunks with ``window``.
    Decode: one chunk with query position 0, so that ``window`` is inert as
    in the reference (C1); the paged reads take no window at all.  Under
    the recurrent families' grid rules (``qkv``: heads over 'model', the
    hybrid's shared blocks) this rank's heads, their output's shares summed
    over the ranks."""
    dt = h.dtype
    B, S, _ = h.shape
    # under the recurrent families' rules ("qkv"), this rank's heads
    hs = head_slice("qkv", 2, cfg.n_heads)
    kvs = head_slice("qkv", 2, cfg.n_kv_heads)
    if hs.stop - hs.start < cfg.n_heads:
        p = head_part(p, hs, kvs, cfg.head_dim)
    q, k, v = project_qkv(p, h, hs.stop - hs.start, kvs.stop - kvs.start,
                          cfg.head_dim)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    cap = cfg.attn_logit_softcap
    if mode == "decode" and block_tables is not None:
        o = paged_decode(q, k, v, cache, block_tables, cache_pos,
                         fused=fused, logit_softcap=cap)
    elif mode == "decode":
        write_decode_rows(cache["k"], k, cache_pos)
        write_decode_rows(cache["v"], v, cache_pos)
        o = flash_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                            causal=False, window=window, kv_limit=cache_pos,
                            logit_softcap=cap, q_chunk=ONE_CHUNK,
                            kv_chunk=ONE_CHUNK)
    else:
        # on a grid (SP) a rank's queries are its sequence block, from
        # position m * S on, and attend to every rank's keys
        k, v = constrain("kv_full", k), constrain("kv_full", v)
        o = flash_attention(q, k, v, causal=cfg.causal, window=window,
                            logit_softcap=cap, q_offset=block_offset(1, S),
                            q_chunk=rc.q_chunk or ONE_CHUNK,
                            kv_chunk=rc.kv_chunk or ONE_CHUNK)
        if cache is not None:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    return head_sum(torch.matmul(o.reshape(B, S, -1), p.wo.to(dt)),
                    "qkv", 2)


def _mla_attention(p: MLA, h: torch.Tensor, cfg: ModelConfig,
                   rc: RunConfig, *, positions, mode: str, cache, cache_pos,
                   block_tables, fused: bool) -> torch.Tensor:
    """MLA sub-block (the reference's ``apply_block`` MLA branch): prefill
    and train decompressed, in ``rc``'s chunks (on a grid over the gathered
    latent), then in prefill the prompt's latent rows written; decode
    absorbed over the contiguous rows or the pools."""
    kw = dict(n_heads=cfg.n_heads, mla=cfg.mla, positions=positions)
    if mode == "decode":
        return mla_block(p, h, **kw, cache=cache, cache_pos=cache_pos,
                         block_tables=block_tables, paged_fused=fused)
    o = mla_block(p, h, **kw, q_chunk=rc.q_chunk or ONE_CHUNK,
                  kv_chunk=rc.kv_chunk or ONE_CHUNK)
    if cache is not None:
        prefill_mla_cache(p, h, cfg.mla, cache, positions)
    return o


def forward(model: LM, cfg: ModelConfig, rc: RunConfig, batch: dict,
            mode: str = "prefill", cache=None, pos=None, block_tables=None):
    """Returns (out, cache, aux).

    train:   ``batch["tokens"]`` (B, S); out = the final hidden states (B,
             S, d) in the compute dtype, causal over the whole sequence, no
             cache; autograd records it (the other modes run under
             ``torch.no_grad``).
    prefill: ``batch["tokens"]`` (B, S); writes the prompt's K/V into rows
             [0, S) of ``cache`` (when given); out = the logits (B, V) f32
             of the last position.
    decode:  ``batch["tokens"]`` (B, 1); ``pos`` a (B,) tensor (or an int
             shared by every row) of cache positions; writes each row's K/V
             at its position and attends to positions <= it.

    ``block_tables`` (B, nb) int32, decode only: ``cache`` is the paged
    pool and row b is one token of a serving step (a decode token or one
    token of a prompt chunk) at its own position, written and read through
    its slot's table row; logits for every row.

    A ``vlm`` batch also holds ``image_embeds`` (B, n_image_tokens, d) for
    train and prefill (decode reads the image's K/V from the cache).  An
    ``encoder_only`` model's batch holds ``features`` (B, S, d) and may hold
    ``mask`` (B, S) bool in place of ``tokens``; it runs train mode only.

    The recurrent families (``ssm``, ``hybrid``) serve over a contiguous
    cache; ``block_tables`` on them, or on a model with ``cross`` blocks,
    raises.  ``rc.ep`` reaches the MoE layers only, as in the reference: on
    a model without one it changes nothing.  Train mode runs every family
    on one device and on a grid (inside ``use_rules``; prefill and decode
    run on one device).
    """
    if block_tables is not None and (cfg.family in RECURRENT_FAMILIES
                                     or cfg.cross_attn_every):
        unpaged = [k for k in dict.fromkeys(layer_kinds(cfg))
                   if k in (*RECURRENT_KINDS, "cross")]
        raise ValueError(f"{cfg.name}: its {', '.join(unpaged)} blocks have "
                         "no positional KV cache to page (see "
                         "serve/kv_cache.py PAGED_KINDS)")
    if cfg.encoder_only and mode != "train":
        raise ValueError(f"{cfg.name} is encoder-only: no decode path (it "
                         f"runs train mode, not {mode!r})")
    if mode == "train":
        if cache is not None or pos is not None or block_tables is not None:
            raise ValueError("train mode takes no cache, pos or block_tables")
        return _forward_train(model, cfg, rc, batch)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port runs train, prefill and "
                         "decode")
    if block_tables is not None and mode != "decode":
        raise ValueError("block_tables is decode-only (chunked prefill "
                         "feeds prompt tokens through decode rows)")
    return _forward_serve(model, cfg, rc, batch, mode, cache, pos,
                          block_tables)


def _forward_train(model: LM, cfg: ModelConfig, rc: RunConfig, batch: dict):
    """With ``rc.remat`` each layer is recomputed in the backward (the
    reference's per-group ``jax.checkpoint(nothing_saveable)``); the layer
    draws no random numbers, so no RNG state is kept for the replay
    (``preserve_rng_state=False``).  With ``rc.moe_stats`` the ``sched/*``
    keys start at fp32 zeros, as the reference's scan carry does.  The
    ``ssm`` family's ``ln0`` follows the embedding, as in every mode.

    On a model sharded over a grid (inside ``use_rules``) ``tokens`` is
    this rank's (B/D, S/M) block, at positions from ``m * S/M`` on (under
    the recurrent families' rules its (B/D, S) rows), and each layer
    gathers its own weights inside itself (``_grid_layer``): under remat
    inside the recomputed function, so no gathered weight outlives its
    layer.  A hybrid model's shared block is gathered at each of its
    applications, and its gradient sums over them."""
    dt = rc.compute_dtype
    x = embed_inputs(model, cfg, batch, dt)
    if cfg.family == "ssm":
        x = model.ln0(x)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device) \
        + block_offset(1, S)
    img = batch.get("image_embeds")
    aux_acc: dict = {}
    if moe_stats_active(rc) and n_moe_layers(cfg):
        aux_acc = {f"sched/{k}": torch.zeros((), dtype=torch.float32,
                                             device=x.device)
                   for k in ScheduleStats._fields}
    sharded = getattr(model, "shard_specs", None) is not None
    kw = {"image_embeds": img}
    for i, blk in enumerate(model.layers):
        fn, args = ((_grid_layer, (model, i)) if sharded
                    else (apply_block, (blk,)))
        if rc.remat:
            x, aux = checkpoint(fn, *args, x, cfg, rc, positions=positions,
                                mode="train", use_reentrant=False,
                                preserve_rng_state=False, **kw)
        else:
            x, aux = fn(*args, x, cfg, rc, positions=positions, mode="train",
                        **kw)
        for key, val in aux.items():
            aux_acc[key] = aux_acc[key] + val if key in aux_acc else val
    return model.final_norm(x), None, aux_acc


def _grid_layer(model: LM, i: int, x, cfg: ModelConfig, rc: RunConfig, *,
                positions, mode: str, image_embeds=None):
    """Layer ``i`` of a sharded model on this rank's block: its weights
    gathered from every rank's block (``full_param``: the compute dtype,
    expert stacks over 'data' only), then ``apply_block`` on them.  A
    hybrid group's shared block is registered, and sharded, as
    ``shared.<j>``, whatever layer applies it."""
    blk = model.layers[i]
    pre = f"layers.{i}."
    for j, shared in enumerate(getattr(model, "shared", ())):
        if blk is shared:
            pre = f"shared.{j}."
    full = {n: full_param(model, cfg, pre + n, rc.compute_dtype)
            for n, _ in blk.named_parameters()}
    return torch.func.functional_call(blk, full, (x, cfg, rc, positions),
                                      {"mode": mode,
                                       "image_embeds": image_embeds})


@torch.no_grad()
def _forward_serve(model: LM, cfg: ModelConfig, rc: RunConfig, batch: dict,
                   mode: str, cache, pos, block_tables):
    fused = paged_fused(rc, cache[0] if block_tables is not None else None)
    dt = rc.compute_dtype
    x = embed_tokens(model, cfg, batch["tokens"], dt)
    if cfg.family == "ssm":
        x = model.ln0(x)
    B, S = x.shape[:2]
    if mode == "decode":
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        pos = pos.expand(B) if pos.dim() == 0 else pos
        positions = pos[:, None]
        cache_pos = pos
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        cache_pos = None
    aux_acc: dict = {}
    img = batch.get("image_embeds")
    for i, blk in enumerate(model.layers):
        c = cache[i] if cache is not None else None
        x, aux = apply_block(blk, x, cfg, rc, positions=positions, mode=mode,
                             cache=c, cache_pos=cache_pos,
                             block_tables=block_tables, fused=fused,
                             image_embeds=img)
        for key, val in aux.items():
            aux_acc[key] = aux_acc[key] + val if key in aux_acc else val
    x = model.final_norm(x)
    x_last = x[:, -1] if mode == "prefill" else x[:, 0]
    logits = torch.matmul(x_last, head_matrix(model, cfg).to(dt)).float()
    return softcap(logits, cfg.final_logit_softcap), cache, aux_acc


def n_moe_layers(cfg: ModelConfig) -> int:
    """Layers of kind ``moe`` (0 for a dense model)."""
    return layer_kinds(cfg).count("moe")


# ----------------------------------------------------------------------
# Loss (chunked over the sequence; the logits never exist whole)
# ----------------------------------------------------------------------
def _chunk_ce(xc: torch.Tensor, w_head: torch.Tensor, yc: torch.Tensor,
              vc: torch.Tensor, final_cap: Optional[float]) -> torch.Tensor:
    logits = softcap(torch.matmul(xc, w_head).float(), final_cap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, yc.long()[..., None])[..., 0]
    return torch.where(vc, lse - gold, torch.zeros_like(lse)).sum()


def chunked_ce(x: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor, *, chunk: int,
               final_cap: Optional[float] = None):
    """x: (B, S, d); labels/valid: (B, S).  Returns (sum_ce f32, n_valid).

    The reference's STRIDED chunks (token s goes to chunk s % nc, with the
    chunk length the largest divisor of S that is <= ``chunk``), each
    recomputed in the backward (``torch.utils.checkpoint``), so only one
    chunk's (B, S/nc, V) logits exist at a time."""
    B, S, d = x.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    nc = S // c
    xs, ys = x.reshape(B, c, nc, d), labels.reshape(B, c, nc)
    vs = valid.reshape(B, c, nc)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(nc):
        tot = tot + checkpoint(_chunk_ce, xs[:, :, j], w_head, ys[:, :, j],
                               vs[:, :, j], final_cap, use_reentrant=False)
    return tot, valid.sum()


def loss_fn(model: LM, cfg: ModelConfig, rc: RunConfig, batch: dict):
    """Next-token CE over ``batch["tokens"]`` (B, S), plus the MoE layers'
    aux losses (0.01 load balance, 1e-4 router z); for an encoder the
    masked-prediction CE: every position against ``batch["labels"]``,
    counted where ``batch["mask"]`` is set.  Returns (loss, metrics), every
    value a device tensor.

    On a grid (inside ``use_rules``) ``batch`` is this rank's block, with
    ``labels``: the next token of each local position that has one
    (``data.pipeline.local_batch``; the sequence's last rank has one
    position fewer), or an encoder's labels of its positions.
    ``chunked_ce`` sums over the local rows, and the loss is the sum over
    every rank over the count over every rank, each divided by the ranks
    that hold the same tokens (``token_replicas``: the 'model' size under
    the recurrent families' rules), so those ranks count their tokens once
    between them and each passes back its share of the gradient."""
    h, _, aux = forward(model, cfg, rc, batch, mode="train")
    w_head = head_matrix(model, cfg, h.dtype).to(h.dtype)
    _, grid = current_rules()
    if cfg.encoder_only:
        labels, valid = batch["labels"], batch["mask"]
    else:
        labels = batch["labels"] if grid is not None \
            else batch["tokens"][:, 1:]
        valid = torch.ones_like(labels, dtype=torch.bool)
    tot, n = chunked_ce(h[:, :labels.shape[1]], w_head, labels, valid,
                        chunk=rc.loss_chunk,
                        final_cap=cfg.final_logit_softcap)
    if grid is not None:
        tot, n = global_sum(tot, grid.world), grid.world.all_reduce(n)
        rep = token_replicas()
        if rep > 1:
            tot, n = tot / rep, n // rep
    loss = tot / torch.clamp(n, min=1)
    metrics = {"ce": loss, "tokens": n.float()}
    if aux:
        metrics.update(aux)
        loss = loss + 0.01 * aux.get("lb_loss", 0.0) \
            + 1e-4 * aux.get("router_z", 0.0)
    return loss, metrics
