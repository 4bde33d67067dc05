"""Cells: (arch x shape [x mesh]) -> a step and its inputs (the port of
``repro.launch.cells``).

For every cell of ``configs.get_cells(ALL_ARCHS)`` and each variant this
module builds:

- the step callable (train step, prefill, decode, serve, candidate
  retrieval, index, search) as ``repro``'s cell runs it, on one device;
- its arguments. On ``meta`` they are tensors of ``repro``'s shapes and
  dtypes with no storage: the counterpart of ``jax.eval_shape`` and
  ``ShapeDtypeStruct`` (shapes, dtypes and bytes, nothing allocated;
  nothing runs there). On ``cuda`` or ``cpu`` they are the same tensors
  filled from a generator: ids inside their vocabulary or table, masks
  all true, store vectors unit-norm bfloat16. ``args[0]`` is the
  family's model (``DecoderLM``, ``EquiformerV2``, ``RecsysModel``,
  ``ColXEncoder``), the counterpart of ``repro``'s params tree, except
  in a search cell, whose first argument is the store dict;
- ``model_flops``, the useful FLOPs of one step (forward + backward for
  a train step), formula for formula ``repro``'s.

Kept from ``repro``: the variants (``base``; ``opt``: ragged MoE dispatch,
no sequence-parallel constraint and 8 checkpointed microbatches for the
LMs, the fused rotation for the GNN, the 2-stage candidate search for
recsys, an int8 scan stage for the retrievers; ``stage1``: the retrievers'
exact 1-stage search), the notes, and ``donate``, which here names the
arguments that ``fn`` updates in place. ``repro``'s ``in_shardings`` is
no field here: a placed argument carries its own sharding. Without a mesh the mesh cuts are those of one device: the
minibatch cell's two-level dp x tp layout is dp = tp = 1, the vertex-cut
cell is one shard of ``ShardedEdges`` (``repro``'s psum over one device is
the identity), and no corpus or candidate list is padded to a shard
multiple.

With ``mesh=`` (``launch.mesh``, one controller) a cell runs sharded on
it. The cells ``repro`` runs through XLA partitioning (``jax.jit(...,
in_shardings=...)``) are partitioned: every argument is placed exactly by
``repro``'s ``in_shardings`` (a ``Sharded`` of per-position slabs that
persists across calls: parameters by ``param_specs``, optimizer moments
by ``opt_state_specs``, the batch by dp, KV caches by
``cache_logical_axes``), the step runs on the slabs with explicit
collectives (``train_loop.make_train_step(mesh=)``, the LM's partitioned
layers, ``late_interaction``'s global in-batch negatives, the molecule
batch by dp; the index cell pools through ``pool.cu`` on every position),
and ``donate`` updates the placed arguments in place. These are the LM
cells (train, prefill, decode; tensor, ZeRO and sequence sharding), the
GNN ``molecule`` cell, the small full-graph GNN cell (its edges over
``flat``, nodes and weights replicated: ``graph.FlatEdges`` sums each
node's messages and its softmax across the positions), every recsys cell
(the big embedding table, bert4rec's item table and their row-wise
accumulators split by rows over tp, a batch over dp, the candidates and
``cand_proxy`` over ``flat``; train through ``make_train_step(mesh=)``,
serve and candidate search as bodies over the slabs) and the retrievers'
train and index cells. On ``meta`` only the slabs' shapes are made. The
cells with explicit per-shard bodies run them (``distributed.shard_map``):
the GNN minibatch cell's two-level dp x tp body and the vertex-cut body
over the flat axis, and the retriever search over the sharded corpus;
their arguments live on the mesh's first device and the bodies split
them. Every one of ``repro``'s 101 cells builds on a mesh.

Also kept: ``repro``'s search ``model_flops`` counts the 2-stage rerank
for the 1-stage (``stage1``) variant too.

``build_cell(arch, shape_name, device, variant)`` dispatches by family;
``build_lm_cell`` and its siblings take a ``ShapeSpec``, so a caller may
pass a smaller shape (``dataclasses.replace(shape, dims=...)``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import get_config, get_shapes
from repro_torch.distributed import placement as PL
from repro_torch.distributed import shard_map as SM
from repro_torch.distributed.placement import bind_params
from repro_torch.distributed.sharding import (Sharded, ShardingPolicy,
                                              device_put, is_meta_mesh,
                                              zeros_placed)
from repro_torch.launch.mesh import home_device, n_devices
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import make_train_step


@dataclass
class Cell:
    arch: str
    shape: str
    fn: object                     # fn(*args)
    args: tuple                    # tensors, dicts of tensors, a model
    donate: tuple = ()             # arguments fn updates in place
    model_flops: float = 0.0       # useful FLOPs per step (fwd+bwd for train)
    note: str = ""


def arg_tensors(args) -> list:
    """Every tensor of a cell's arguments: a model's parameters, the
    leaves of dicts, lists and tuples."""
    if isinstance(args, torch.Tensor):
        return [args]
    if isinstance(args, Sharded):
        return list(args.slabs)
    if isinstance(args, nn.Module):
        return list(args.parameters())
    if isinstance(args, dict):
        args = list(args.values())
    out = []
    for a in args:
        out += arg_tensors(a)
    return out


def arg_bytes(cell: Cell) -> int:
    """Bytes of a cell's arguments (parameters, optimizer state, batch,
    caches, store)."""
    return sum(t.numel() * t.element_size() for t in arg_tensors(cell.args))


class _Fill:
    """A cell's input tensors on ``dev``: storage-free on ``meta``, else
    drawn from ``gen`` on its own device and moved to ``dev``."""

    def __init__(self, dev: torch.device, gen):
        self.dev, self.gen = dev, gen
        self.meta = dev.type == "meta"

    def _out(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, device=self.dev)

    def ids(self, shape, high) -> torch.Tensor:
        """int32 ids uniform in [0, high); ``high`` per column when a
        tuple (one vocabulary per field)."""
        if self.meta:
            return self._out(shape, torch.int32)
        if isinstance(high, (tuple, list)):
            cols = [torch.randint(0, int(h), tuple(shape[:-1]),
                                  generator=self.gen, device=self.gen.device)
                    for h in high]
            x = torch.stack(cols, dim=-1)
        else:
            x = torch.randint(0, int(high), tuple(shape), generator=self.gen,
                              device=self.gen.device)
        return x.to(self.dev, torch.int32)

    def normal(self, shape) -> torch.Tensor:
        if self.meta:
            return self._out(shape, torch.float32)
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.gen.device).to(self.dev)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        if self.meta:
            return self._out(shape, torch.float32)
        u = torch.rand(tuple(shape), generator=self.gen,
                       device=self.gen.device)
        return (lo + (hi - lo) * u).to(self.dev)

    def binary(self, shape) -> torch.Tensor:
        """float32 0/1 labels."""
        if self.meta:
            return self._out(shape, torch.float32)
        return self.ids(shape, 2).float()

    def ones(self, shape, dtype=torch.bool) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=dtype, device=self.dev)

    def unit(self, shape, dtype, chunk: int = 8192) -> torch.Tensor:
        """Unit-norm vectors along the last axis, drawn in float32
        ``chunk`` rows at a time and stored as ``dtype``."""
        out = self._out(shape, dtype)
        if self.meta:
            return out
        for i in range(0, shape[0], chunk):
            n = min(chunk, shape[0] - i)
            x = torch.randn((n,) + tuple(shape[1:]), generator=self.gen,
                            device=self.gen.device).to(self.dev)
            out[i:i + n] = (x / x.norm(dim=-1, keepdim=True)).to(dtype)
        return out


def _setup(device, generator, mesh=None) -> tuple:
    """(device, model generator, input filler): a meta cell draws
    nothing; otherwise ``generator`` (default: one seeded 0 on the
    device) draws the weights and then the inputs. The device defaults
    to the card, or with a mesh to its first device (where a cell's
    arguments live)."""
    if mesh is not None and device is not None and \
            torch.device(device).type == "meta":
        dev = torch.device("meta")
    else:
        dev = home_device(mesh, device)
    if dev.type == "meta":
        return dev, None, _Fill(dev, None)
    gen = generator if generator is not None else \
        torch.Generator(dev).manual_seed(0)
    return dev, gen, _Fill(dev, gen)


def _building(dev):
    """Construct a model under this context: on ``meta`` every factory
    call without a device lands there too, so nothing is allocated."""
    return torch.device("meta") if dev.type == "meta" \
        else contextlib.nullcontext()


def _placed_params(tmpl, shardings: dict, fill, make) -> dict:
    """A model's leaves placed by ``shardings``: storage-free slabs on
    ``meta``, else ``make()``'s model placed leaf by leaf."""
    if fill.meta:
        return PL.empty_model(tmpl, shardings, torch.device("meta"))
    model = make()
    placed = PL.place_model(model, shardings)
    del model
    return placed


def _placed_train(loss, oc, params, batch, bshard, mesh):
    """(step, (params, opt state, batch)): ``init_opt_state`` of placed
    parameters and ``make_train_step`` over the mesh."""
    labels = OPT.default_labels(params)
    opt_state = OPT.init_opt_state(params, labels)
    pshard = {n: p.sharding for n, p in params.items()}
    step = make_train_step(loss, oc, labels=labels, mesh=mesh,
                           in_specs=(pshard, SM.in_specs_of(opt_state),
                                     bshard))
    return step, (params, opt_state, device_put(batch, bshard, copy=True))


def _train_state(model, oc) -> tuple:
    """(optimizer state, labels) of ``model``: ``init_opt_state`` over its
    named parameters under ``default_labels``."""
    params = dict(model.named_parameters())
    labels = OPT.default_labels(params)
    return OPT.init_opt_state(params, labels), labels


# ===========================================================================
# LM family
# ===========================================================================

def _lm_batch_flops(cfg, tokens: int, train: bool) -> float:
    per_tok = 6.0 * cfg.n_active_params()
    return per_tok * tokens * (1.0 if train else 1.0 / 3.0)


def _micro_loss(model, tokens, labels, shard=None):
    from repro_torch.models import transformer as T
    return T.loss_fn(model, {"tokens": tokens, "labels": labels}, shard)


def build_lm_cell(arch: str, shape, device=None, variant: str = "base",
                  generator=None, mesh=None) -> Cell:
    from repro_torch.models import kv_cache as KV
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    micro = 1
    if variant == "opt":
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, impl="ragged_ep"))
        cfg = dataclasses.replace(cfg, sp_activations=False)
        micro = 8
    dev, gen, fill = _setup(device, generator, mesh)
    if mesh is not None:
        return _lm_mesh_cell(arch, shape, cfg, micro, mesh, dev, gen, fill)
    pol = None
    with _building(dev):
        model = T.init_params(cfg, gen, dev)
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        oc = OPT.OptConfig(schedule="wsd" if "minicpm" in arch else "cosine")
        opt_state, labels = _train_state(model, oc)

        def loss(m, b):
            if micro <= 1:
                return T.loss_fn(m, b, pol)
            # gradient accumulation as ``repro``'s checkpointed scan: the
            # microbatch losses summed in order, then averaged; each
            # microbatch's activations are recomputed in the backward
            n, s = b["tokens"].shape
            tk = b["tokens"].reshape(micro, n // micro, s)
            lb = b["labels"].reshape(micro, n // micro, s)
            tot = torch.zeros((), dtype=torch.float32, device=tk.device)
            for t, l in zip(tk, lb):
                tot = tot + checkpoint(_micro_loss, m, t, l, pol,
                                       use_reentrant=False)
            return tot / micro

        step = make_train_step(loss, oc, labels=labels)
        batch = {"tokens": fill.ids((B, S), cfg.vocab_size),
                 "labels": fill.ids((B, S), cfg.vocab_size)}
        return Cell(arch, shape.name, step, (model, opt_state, batch),
                    donate=(0, 1),
                    model_flops=_lm_batch_flops(cfg, B * S, True))

    if shape.kind == "prefill":
        batch = {"tokens": fill.ids((B, S), cfg.vocab_size)}
        return Cell(arch, shape.name, T.prefill_step, (model, batch),
                    model_flops=_lm_batch_flops(cfg, B * S, False))

    # decode (decode_32k / long_500k): one token against a seq_len KV cache
    caches = KV.init_cache(cfg, T.segment_plan(cfg), B, S,
                           T.compute_dtype(cfg), device=dev)
    tok = fill.ids((B, 1), cfg.vocab_size)
    pos = torch.full((), S - 1, dtype=torch.int32, device=dev)
    # decode useful FLOPs: params touched once per token (2*N_active*B)
    flops = 2.0 * cfg.n_active_params() * B
    return Cell(arch, shape.name, T.decode_step, (model, caches, tok, pos),
                donate=(1,), model_flops=flops)


def _lm_mesh_cell(arch, shape, cfg, micro, mesh, dev, gen, fill) -> Cell:
    """The LM cell partitioned over ``mesh`` (module docstring)."""
    from repro_torch.models import kv_cache as KV
    from repro_torch.models import transformer as T

    pol = ShardingPolicy(mesh)
    tmpl = T.template(cfg)
    lmap = PL.leaf_map(tmpl)
    pshard = T.leaf_shardings(cfg, pol)
    with _building(dev):
        params = _placed_params(tmpl, pshard, fill,
                                lambda: T.init_params(cfg, gen, dev))
    B, S = shape.global_batch, shape.seq_len
    body_pol = pol.body(batch=B)
    pspecs = SM.in_specs_of(pshard)

    def local(p):
        return T.local_model(tmpl, p, lmap)

    if shape.kind == "train":
        oc = OPT.OptConfig(schedule="wsd" if "minicpm" in arch else "cosine")
        bshard = {"tokens": pol.named("dp", None),
                  "labels": pol.named("dp", None)}

        def loss(p, b):
            m = local(p)
            if micro <= 1:
                return T.loss_fn(m, b, body_pol)
            # ``repro``'s checkpointed microbatches: microbatch i is the
            # global rows [i B/micro, (i+1) B/micro), split over dp as
            # GSPMD splits them (an all_to_all from this position's rows),
            # each its own global mean, averaged
            n, s = b["tokens"].shape
            dpn = B // n
            if (B // micro) % dpn:
                raise ValueError(f"{micro} microbatches of a batch of {B} "
                                 f"do not split over dp = {dpn}")
            mpol = pol.body(batch=B // micro)

            def microbatches(x):
                if micro % dpn:
                    # more dp positions than microbatches (the production
                    # meshes): a position's rows lie in one microbatch, so
                    # the batch is gathered and each position keeps its
                    # rows of every microbatch
                    x = pol.constrain(x, None, None, have=("dp", None))
                    return pol.constrain(x.reshape(micro, B // micro, s),
                                         None, "dp", None)
                x = x.reshape(micro // dpn, B // micro, s)
                return pol.constrain(x, None, "dp", None,
                                     have=("dp", None, None))
            tk, lb = microbatches(b["tokens"]), microbatches(b["labels"])
            tot = torch.zeros((), dtype=torch.float32, device=tk.device)
            for t, l in zip(tk, lb):
                tot = tot + SM.checkpoint(_micro_loss, m, t, l, mpol)
            return tot / micro

        batch = {"tokens": fill.ids((B, S), cfg.vocab_size),
                 "labels": fill.ids((B, S), cfg.vocab_size)}
        step, args = _placed_train(loss, oc, params, batch, bshard, mesh)
        return Cell(arch, shape.name, step, args, donate=(0, 1),
                    model_flops=_lm_batch_flops(cfg, B * S, True))

    logits_spec = pol.spec("dp" if B > 1 else None, None, "tp")
    plan = T.segment_plan(cfg)
    cshard = KV.cache_shardings(cfg, plan, B, pol)
    cspecs = SM.in_specs_of(cshard)
    if shape.kind == "prefill":
        bshard = {"tokens": pol.named("dp", None)}
        placed_caches = [[{k: SM.Placed(*v) for k, v in slot.items()}
                          for slot in seg] for seg in cspecs]
        fn_ = SM.shard_map(
            lambda p, b: T.prefill_step(local(p), b, shard=body_pol), mesh,
            (pspecs, SM.in_specs_of(bshard)), (logits_spec, placed_caches))
        batch = device_put({"tokens": fill.ids((B, S), cfg.vocab_size)},
                           bshard, copy=True)
        return Cell(arch, shape.name, fn_, (params, batch),
                    model_flops=_lm_batch_flops(cfg, B * S, False))

    # decode (decode_32k / long_500k): one token against a seq_len KV cache
    # split over the sequence (over ``flat`` at batch 1)
    dtype = T.compute_dtype(cfg)
    caches = [[{k: zeros_placed(cshard[si][ki][k], sd.shape, dtype,
                                dev if fill.meta else None)
                for k, sd in slot.items()} for ki, slot in enumerate(seg)]
              for si, seg in enumerate(KV.cache_specs(cfg, plan, B, S,
                                                      dtype))]
    tshard = pol.named("dp", None) if B > 1 else pol.named(None, None)
    tok = device_put(fill.ids((B, 1), cfg.vocab_size), tshard, copy=True)
    if is_meta_mesh(mesh):
        # the body reads the position's value on the host (``int``); a
        # meta device holds no value, so on a meta mesh (the dry run)
        # every position's slab is one host tensor
        pos = Sharded(pol.named(), (), (torch.full(
            (), S - 1, dtype=torch.int32),) * mesh.size)
    else:
        pos = device_put(torch.full((), S - 1, dtype=torch.int32,
                                    device=dev), pol.named(), copy=True)

    def body(p, c, t, ps):
        return T.decode_step(local(p), c, t, ps, shard=body_pol)[0]

    fn_ = SM.shard_map(body, mesh, (pspecs, cspecs, SM.in_specs_of(tshard),
                                    SM.P()), logits_spec)
    flops = 2.0 * cfg.n_active_params() * B
    return Cell(arch, shape.name, fn_, (params, caches, tok, pos),
                donate=(1,), model_flops=flops)


# ===========================================================================
# GNN family
# ===========================================================================

def _gnn_layer_flops(cfg, n_edges: float) -> float:
    """Per-edge eSCN cost: 3 SO(2) convs + 2 rotation applies."""
    C = cfg.d_hidden
    n0 = cfg.l_max + 1
    conv = (n0 * C) ** 2 * 2
    for m in range(1, cfg.m_max + 1):
        conv += 4 * ((n0 - m) * C) ** 2 * 2
    rot = sum((2 * l + 1) ** 2 for l in range(n0)) * C * 2 * 2
    return n_edges * (3 * conv + rot)


def _gnn_flops(cfg, n_edges: float, train: bool) -> float:
    f = cfg.n_layers * _gnn_layer_flops(cfg, n_edges)
    return f * (3.0 if train else 1.0)


def _sharded_batch(fill: _Fill, lead: tuple, n_local: int, n_pad: int,
                   cap: int, consistent: bool) -> dict:
    """``ShardedEdges`` arrays [*lead, cap]: local src and dst ids in [0,
    n_local), global ones in [0, n_pad). At one shard (``consistent``)
    the receive side is the send side (rdst = edstg, rsrcg = esrc); over
    a mesh both sides are drawn apart, every id inside its range."""
    esrc = fill.ids(lead + (cap,), n_local)
    edstg = fill.ids(lead + (cap,), n_pad)
    emask = fill.ones(lead + (cap,))
    if consistent:
        return {"esrc": esrc, "edstg": edstg, "emask": emask,
                "rdst": edstg.clone(), "rsrcg": esrc.clone(),
                "rmask": emask.clone()}
    return {"esrc": esrc, "edstg": edstg, "emask": emask,
            "rdst": fill.ids(lead + (cap,), n_local),
            "rsrcg": fill.ids(lead + (cap,), n_pad),
            "rmask": fill.ones(lead + (cap,))}


_EDGE_KEYS = ("esrc", "edstg", "emask", "rdst", "rsrcg", "rmask")


def _shard_plan(b: dict, idx: tuple, n_local: int, offset: int = 0,
                axis_names: tuple = ()):
    from repro_torch.models.gnn.graph import ShardedEdges
    return ShardedEdges(**{k: b[k][idx] for k in _EDGE_KEYS},
                        n_local=n_local, shard_offset=offset,
                        axis_names=axis_names)


def sharded_ce_loss(cfg, model, plan, feat, pos, labels, lmask, axes):
    """``repro``'s per-shard node loss: the shard's summed cross-entropy
    over its labelled nodes and its label count, each ``psum``'d over
    ``axes``, their quotient (the same on every position)."""
    from repro_torch.models.gnn import equiformer_v2 as E
    logits = E.forward(cfg, model, plan, feat, pos)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    m = lmask.to(torch.float32)
    num = SM.psum(torch.sum((logz - gold) * m), axes)
    den = SM.psum(torch.sum(m), axes)
    return num / torch.clamp(den, min=1.0)


def minibatch_loss(cfg, mesh, n_local: int, dp_axes: tuple, tp_axes: tuple):
    """``repro``'s two-level minibatch loss over ``mesh``: one sampled
    subgraph per dp position, each vertex-cut over tp. Each position
    takes its [1, n_local] block of the nodes (``P(dp, tp)``) and its
    subgraph's whole [1, tp, tp, cap] edge arrays (``P(dp)``), and builds
    its plan from bucket row [0, 0] of them, as ``repro``'s body does."""
    P = SM.P

    def loss(m, b):
        def body(params, feat, pos, labels_, lmask, esrc, edstg, emask,
                 rdst, rsrcg, rmask):
            e = dict(zip(_EDGE_KEYS, (esrc, edstg, emask, rdst, rsrcg,
                                      rmask)))
            plan = _shard_plan(e, (0, 0), n_local,
                               SM.axis_index(tp_axes) * n_local, tp_axes)
            return sharded_ce_loss(cfg, bind_params(m, params), plan,
                                   feat[0], pos[0], labels_[0], lmask[0],
                                   dp_axes + tp_axes)

        return SM.shard_map(
            body, mesh,
            in_specs=(P(), P(dp_axes, tp_axes), P(dp_axes),
                      P(dp_axes, tp_axes), P(dp_axes, tp_axes))
            + (P(dp_axes),) * 6,
            out_specs=P(),
        )(dict(m.named_parameters()), b["feat"], b["pos"], b["labels"],
          b["lmask"], *[b[k] for k in _EDGE_KEYS])
    return loss


def vertex_cut_loss(cfg, mesh, n_local: int, flat_axes: tuple):
    """``repro``'s vertex-cut loss over every mesh axis: each position
    holds n_local nodes and row s of the [S, S, cap] buckets; positions
    are replicated (``P()``)."""
    P = SM.P

    def loss(m, b):
        def body(params, feat, pos, labels_, lmask, esrc, edstg, emask,
                 rdst, rsrcg, rmask):
            e = dict(zip(_EDGE_KEYS, (esrc, edstg, emask, rdst, rsrcg,
                                      rmask)))
            plan = _shard_plan(e, (0,), n_local,
                               SM.axis_index(flat_axes) * n_local, flat_axes)
            return sharded_ce_loss(cfg, bind_params(m, params), plan, feat,
                                   pos, labels_, lmask, flat_axes)

        return SM.shard_map(
            body, mesh,
            in_specs=(P(), P(flat_axes), P()) + (P(flat_axes),) * 8,
            out_specs=P(),
        )(dict(m.named_parameters()), b["feat"], b["pos"], b["labels"],
          b["lmask"], *[b[k] for k in _EDGE_KEYS])
    return loss


def build_gnn_cell(arch: str, shape, device=None, variant: str = "base",
                   generator=None, mesh=None) -> Cell:
    from repro_torch.models.gnn import equiformer_v2 as E
    from repro_torch.models.gnn.graph import LocalEdges

    base = get_config(arch)
    cfg = dataclasses.replace(base, msg_dtype="bfloat16",
                              fused_rotation=(variant == "opt"))
    pol = ShardingPolicy(mesh)
    dev, gen, fill = _setup(device, generator, mesh)
    oc = OPT.OptConfig()

    def model_of(d_feat: int, n_out: int):
        with _building(dev):
            return E.init_params(cfg, d_feat, n_out, gen, dev)

    def train_cell(model, loss, batch, flops, note=""):
        opt_state, labels = _train_state(model, oc)
        step = make_train_step(loss, oc, labels=labels)
        return Cell(arch, shape.name, step, (model, opt_state, batch),
                    donate=(0, 1), model_flops=flops, note=note)

    if shape.kind == "batched_graphs" and mesh is not None:
        return _molecule_mesh_cell(arch, shape, cfg, oc, mesh, pol, dev,
                                   fill, lambda: model_of(shape.d_feat, 1))

    if shape.kind == "batched_graphs":          # molecule
        model = model_of(shape.d_feat, 1)

        def loss(m, b):
            # ``repro`` vmaps the graphs; one disjoint union gives the
            # same mean of per-graph losses
            return E.batched_graph_energy_loss(
                cfg, m, b["feat"], b["pos"], b["src"], b["dst"], b["emask"],
                b["target"])

        return train_cell(model, loss, _molecule_batch(fill, shape),
                          _gnn_flops(cfg, shape.batch * shape.n_edges, True))

    if shape.kind == "minibatch":
        # ``repro``: one sampled subgraph per data shard, each vertex-cut
        # over the model axis (dp = tp = 1 without a mesh)
        from repro_torch.models.gnn.sampler import max_subgraph_shape
        NN, EE = max_subgraph_shape(shape.batch_nodes, tuple(shape.fanout))
        F, G, n_cls = shape.d_feat, pol.axis_size("dp"), 41
        tp = max(pol.axis_size("tp"), 1)
        n_local = -(-NN // tp)
        N_pad = n_local * tp
        cap = max(8, int(np.ceil(EE / (tp * tp) * 2.0 / 8)) * 8)
        model = model_of(F, n_cls)

        if mesh is None:
            def loss(m, b):
                plan = _shard_plan(b, (0, 0), n_local)
                return E.node_ce_loss(cfg, m, plan, b["feat"][0],
                                      b["pos"][0], b["labels"][0],
                                      b["lmask"][0])
        else:
            loss = minibatch_loss(cfg, mesh, n_local, pol.rules["dp"],
                                  ("model",))

        batch = {"feat": fill.normal((G, N_pad, F)),
                 "pos": fill.uniform((G, N_pad, 3), -2.0, 2.0),
                 "labels": fill.ids((G, N_pad), n_cls),
                 "lmask": fill.ones((G, N_pad)),
                 **_sharded_batch(fill, (G, tp, tp), n_local, N_pad, cap,
                                  mesh is None)}
        if mesh is not None:
            # placed as ``repro`` places the batch (its ``in_shardings``:
            # edge buckets over dp x tp, which the body reshards to dp),
            # so a position holds what a device holds
            batch = device_put(batch, {
                k: pol.named("dp", None, None) if k == "pos" else
                pol.named("dp", "tp", *([None] * (v.ndim - 2)))
                for k, v in batch.items()})
        return train_cell(model, loss, batch, _gnn_flops(cfg, G * EE, True),
                          note=f"two-level dp={G} x tp={tp}, cap={cap}")

    # full_graph: small -> one edge list (over ``flat`` on a mesh); large
    # -> the vertex cut over every mesh position (one shard without a mesh)
    NN, EE, F = shape.n_nodes, shape.n_edges, shape.d_feat
    n_cls = 47
    if EE <= 2_000_000 and mesh is not None:     # Cora-scale, partitioned
        return _full_graph_mesh_cell(arch, shape, cfg, oc, mesh, pol, dev,
                                     fill, lambda: model_of(F, n_cls))
    model = model_of(F, n_cls)
    if EE <= 2_000_000:                          # Cora-scale
        def loss(m, b):
            plan = LocalEdges(b["src"], b["dst"], b["emask"], NN)
            return E.node_ce_loss(cfg, m, plan, b["feat"], b["pos"],
                                  b["labels"], b["lmask"])

        return train_cell(model, loss, _full_graph_batch(fill, NN, EE, F,
                                                         n_cls, EE),
                          _gnn_flops(cfg, EE, True))

    # ogbn-products scale: ``repro``'s vertex cut over every device
    S = n_devices(mesh) if mesh is not None else 1
    n_local = -(-NN // S)
    N_pad = n_local * S
    cap = max(8, int(np.ceil(EE / (S * S) * 1.25 / 8.0)) * 8)

    if mesh is None:
        def loss(m, b):
            plan = _shard_plan(b, (0,), n_local)
            return E.node_ce_loss(cfg, m, plan, b["feat"], b["pos"],
                                  b["labels"], b["lmask"])
    else:
        loss = vertex_cut_loss(cfg, mesh, n_local, tuple(mesh.axis_names))

    batch = {"feat": fill.normal((N_pad, F)),
             "pos": fill.uniform((N_pad, 3), -2.0, 2.0),
             "labels": fill.ids((N_pad,), n_cls),
             "lmask": fill.ones((N_pad,)),
             **_sharded_batch(fill, (S, S), n_local, N_pad, cap,
                              mesh is None)}
    return train_cell(model, loss, batch, _gnn_flops(cfg, EE, True),
                      note=f"vertex-cut S={S} cap={cap}")


def _full_graph_batch(fill, NN: int, EE: int, F: int, n_cls: int,
                      n_edges: int) -> dict:
    """A full graph's batch of ``EE`` edge slots, the first ``n_edges`` of
    them real (the rest padding, ``emask`` false)."""
    emask = fill.ones((EE,))
    if not fill.meta:
        emask[n_edges:] = False
    return {"feat": fill.normal((NN, F)),
            "pos": fill.uniform((NN, 3), -2.0, 2.0),
            "src": fill.ids((EE,), NN),
            "dst": fill.ids((EE,), NN),
            "emask": emask,
            "labels": fill.ids((NN,), n_cls),
            "lmask": fill.ones((NN,))}


def _full_graph_mesh_cell(arch, shape, cfg, oc, mesh, pol, dev, fill,
                          make) -> Cell:
    """``full_graph_sm`` over ``mesh`` as ``repro`` places it: the edges
    padded to a multiple of the positions and split over ``flat``, nodes,
    weights and moments replicated. Each position computes its own
    edges' messages; ``FlatEdges`` sums them (and each node's softmax)
    across the positions, so every position holds every node's features
    and computes the same loss, which enters the gradient once
    (``shard_map``'s ``P()`` rule: each copy takes 1/S of the cotangent,
    the replicated weights' gradients are summed over the S)."""
    from repro_torch.models.gnn import equiformer_v2 as E
    from repro_torch.models.gnn.graph import FlatEdges

    NN, F, n_cls = shape.n_nodes, shape.d_feat, 47
    S = n_devices(mesh)
    EE = -(-shape.n_edges // S) * S              # pad edges to shard
    with torch.device("meta"):
        tmpl = E.init_params(cfg, F, n_cls, None, "meta")
    lmap = PL.leaf_map(tmpl)
    pshard = {n: pol.named() for n in tmpl.jax_leaf_names()}
    with _building(dev):
        params = _placed_params(tmpl, pshard, fill, make)
    flat = pol.axes("flat")

    def loss(p, b):
        plan = FlatEdges(b["src"], b["dst"], b["emask"], NN, flat)
        return E.node_ce_loss(cfg, PL.local_module(tmpl, p, lmap), plan,
                              b["feat"], b["pos"], b["labels"], b["lmask"])

    batch = _full_graph_batch(fill, NN, EE, F, n_cls, shape.n_edges)
    bshard = {k: (pol.named("flat") if k in ("src", "dst", "emask") else
                  pol.named(*([None] * v.ndim))) for k, v in batch.items()}
    step, args = _placed_train(loss, oc, params, batch, bshard, mesh)
    return Cell(arch, shape.name, step, args, donate=(0, 1),
                model_flops=_gnn_flops(cfg, EE, True))


def _molecule_batch(fill, shape) -> dict:
    G, NN, EE, F = shape.batch, shape.n_nodes, shape.n_edges, shape.d_feat
    # positions in [-2, 2]^3: every edge inside the 8.0 radial cutoff
    return {"feat": fill.normal((G, NN, F)),
            "pos": fill.uniform((G, NN, 3), -2.0, 2.0),
            "src": fill.ids((G, EE), NN),
            "dst": fill.ids((G, EE), NN),
            "emask": fill.ones((G, EE)),
            "target": fill.normal((G,))}


def _molecule_mesh_cell(arch, shape, cfg, oc, mesh, pol, dev, fill, make):
    """``molecule`` data-parallel over ``mesh``: parameters and moments
    replicated (``repro``'s ``_replicated_like``), the graphs split over
    dp; each position's squared errors summed, ``psum``'d over dp, over
    the global graph count."""
    from repro_torch.models.gnn import equiformer_v2 as E

    with torch.device("meta"):
        tmpl = E.init_params(cfg, shape.d_feat, 1, None, "meta")
    lmap = PL.leaf_map(tmpl)
    pshard = {n: pol.named() for n in tmpl.jax_leaf_names()}
    with _building(dev):
        params = _placed_params(tmpl, pshard, fill, make)
    G = shape.batch
    dp = pol.axes("dp")

    def loss(p, b):
        sq = E.batched_graph_sq_errors(
            cfg, PL.local_module(tmpl, p, lmap), b["feat"], b["pos"],
            b["src"], b["dst"], b["emask"], b["target"])
        return SM.psum(sq.sum(), dp) / G

    batch = _molecule_batch(fill, shape)
    bshard = {k: pol.named("dp", *([None] * (v.ndim - 1)))
              for k, v in batch.items()}
    step, args = _placed_train(loss, oc, params, batch, bshard, mesh)
    return Cell(arch, shape.name, step, args, donate=(0, 1),
                model_flops=_gnn_flops(cfg, G * shape.n_edges, True))


# ===========================================================================
# RecSys family
# ===========================================================================

def _recsys_dense_flops(cfg, batch: float) -> float:
    def mlp_f(dims):
        return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
    f = 0.0
    if cfg.name == "dcn-v2":
        d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
        f = cfg.n_cross_layers * 2.0 * d0 * d0 + mlp_f((d0,) + tuple(cfg.mlp))
    elif cfg.name == "autoint":
        F, d, H, da = cfg.n_sparse, cfg.embed_dim, cfg.n_heads, cfg.d_attn
        din = d
        for _ in range(cfg.n_attn_layers):
            f += 2.0 * F * din * H * da * 3 + 2.0 * F * F * H * da * 2 \
                + 2.0 * F * din * H * da
            din = H * da
        f += 2.0 * F * H * da
    elif cfg.name == "dlrm-mlperf":
        f = mlp_f((cfg.n_dense,) + tuple(cfg.bot_mlp))
        n_vec = cfg.n_sparse + 1
        f += 2.0 * n_vec * n_vec * cfg.embed_dim
        n_int = n_vec * (n_vec - 1) // 2
        f += mlp_f((n_int + cfg.embed_dim,) + tuple(cfg.top_mlp))
    elif cfg.name == "bert4rec":
        d, S_ = cfg.embed_dim, cfg.seq_len
        per_blk = 2.0 * S_ * d * d * 4 + 2.0 * S_ * S_ * d * 2 \
            + 2.0 * S_ * d * 8 * d
        f = cfg.n_blocks * per_blk
    return f * batch


def _recsys_params(cfg, pol, dev, gen, fill) -> tuple:
    """(the cell's first argument, ``local``): the model on one device
    (``local`` the identity), or on a mesh its leaves placed by
    ``param_specs`` (the big table and bert4rec's item table split by
    rows over tp, their rows padded to a multiple of tp; the rest
    replicated) with ``local`` binding one position's slabs to the
    model's structure."""
    from repro_torch.models.recsys import nets as R
    if pol is None:
        with _building(dev):
            model = R.init_params(cfg, gen, dev)
        return model, lambda m: m
    tp = pol.axis_size("tp")
    with torch.device("meta"):
        tmpl = R.init_params(cfg, None, "meta", tp)
    lmap = PL.leaf_map(tmpl)
    specs = R.param_specs(cfg, tmpl)
    pshard = {n: pol.named(*specs[n.replace("/", ".")])
              for n in tmpl.jax_leaf_names()}
    with _building(dev):
        params = _placed_params(tmpl, pshard, fill,
                                lambda: R.init_params(cfg, gen, dev, tp))
    return params, lambda p: PL.local_module(tmpl, p, lmap)


def build_recsys_cell(arch: str, shape, device=None, variant: str = "base",
                      generator=None, mesh=None) -> Cell:
    from repro_torch.models.recsys import nets as R

    cfg = get_config(arch)
    pol = ShardingPolicy(mesh) if mesh is not None else None
    body = pol.body() if pol is not None else None
    dev, gen, fill = _setup(device, generator, mesh)
    first, local = _recsys_params(cfg, pol, dev, gen, fill)
    item_rows = cfg.n_items if cfg.name == "bert4rec" else \
        cfg.vocab_sizes[R._item_field(cfg)]

    def batch_for(B):
        if cfg.name == "bert4rec":
            M, K = 40, 256
            return {"seq": fill.ids((B, cfg.seq_len), cfg.n_items),
                    "seq_mask": fill.ones((B, cfg.seq_len)),
                    "mlm_positions": fill.ids((B, M), cfg.seq_len),
                    "mlm_labels": fill.ids((B, M), cfg.n_items),
                    "mlm_mask": fill.ones((B, M)),
                    "neg_samples": fill.ids((K,), cfg.n_items)}
        b = {"sparse": fill.ids((B, cfg.n_sparse), tuple(cfg.vocab_sizes)),
             "labels": fill.binary((B,))}
        if cfg.n_dense:
            b["dense"] = fill.normal((B, cfg.n_dense))
        return b

    def by_rows(b):
        """``repro``'s ``batch_for``: rows over dp, the shared negatives
        replicated."""
        return {k: pol.named(*((None,) if k == "neg_samples" else
                               ("dp",) + (None,) * (v.ndim - 1)))
                for k, v in b.items()}

    def by_cands(b):
        """The candidates and their proxies over ``flat``, the query
        replicated."""
        return {k: pol.named(*(("flat",) + (None,) * (v.ndim - 1)
                               if k in ("candidates", "cand_proxy")
                               else (None,) * v.ndim))
                for k, v in b.items()}

    def body_fn(fn, bshard, out_specs):
        """``fn`` as a body over the placed slabs and batch."""
        return SM.shard_map(fn, mesh, (SM.in_specs_of(first),
                                       SM.in_specs_of(bshard)), out_specs)

    if shape.kind == "train":
        B = shape.batch
        oc = OPT.OptConfig(lr=1e-3)
        batch = batch_for(B)

        def loss(m, b):
            return R.loss_fn(cfg, local(m), b, body)

        flops = 3.0 * _recsys_dense_flops(cfg, B)
        if pol is not None:
            step, args = _placed_train(loss, oc, first, batch,
                                       by_rows(batch), mesh)
            return Cell(arch, shape.name, step, args, donate=(0, 1),
                        model_flops=flops)
        opt_state, labels = _train_state(first, oc)
        step = make_train_step(loss, oc, labels=labels)
        return Cell(arch, shape.name, step, (first, opt_state, batch),
                    donate=(0, 1), model_flops=flops)

    if shape.kind == "serve":
        B = shape.batch
        batch = batch_for(B)
        if cfg.name == "bert4rec":
            batch = {"seq": batch["seq"], "seq_mask": batch["seq_mask"],
                     "slate": fill.ids((B, 64), cfg.n_items)}
        else:
            batch.pop("labels")
        fn = lambda m, b: R.serve_step(cfg, local(m), b, shard=body)
        if pol is not None:
            bshard = by_rows(batch)
            fn = body_fn(fn, bshard, pol.spec("dp", None)
                         if cfg.name == "bert4rec" else pol.spec("dp"))
            batch = device_put(batch, bshard, copy=True)
        return Cell(arch, shape.name, fn, (first, batch),
                    model_flops=_recsys_dense_flops(cfg, B))

    # retrieval_cand: the candidate list padded to shard over every mesh
    # position (not padded on one device)
    ndev = n_devices(mesh) if mesh is not None else 1
    N = -(-shape.n_candidates // ndev) * ndev
    if cfg.name == "bert4rec":
        batch = {"seq": fill.ids((1, cfg.seq_len), cfg.n_items),
                 "seq_mask": fill.ones((1, cfg.seq_len)),
                 "candidates": fill.ids((N,), item_rows)}
    else:
        batch = {"sparse": fill.ids((1, cfg.n_sparse),
                                    tuple(cfg.vocab_sizes)),
                 "candidates": fill.ids((N,), item_rows)}
        if cfg.n_dense:
            batch["dense"] = fill.normal((1, cfg.n_dense))
    n_stages = 2 if variant == "opt" else 1
    if variant == "opt":
        batch["cand_proxy"] = fill.normal((N, 16))

    def fn(m, b):
        # ``repro``'s opt adds its two-level top-k merge, which over one
        # device selects what ``lax.top_k`` selects
        return R.retrieval_step(cfg, local(m), b, stages=n_stages,
                                two_level_topk=(variant == "opt"),
                                shard=body)

    if pol is not None:
        bshard = by_cands(batch)
        fn = body_fn(fn, bshard, (SM.P(), SM.P()))
        batch = device_put(batch, bshard, copy=True)
    flops = _recsys_dense_flops(cfg, N if n_stages == 1 else 256)
    return Cell(arch, shape.name, fn, (first, batch), model_flops=flops,
                note=f"stages={n_stages}")


# ===========================================================================
# Retriever family (the paper's own models; §Perf serving rows)
# ===========================================================================

def _index_fn(cfg, pm: torch.Tensor):
    from repro_torch.kernels.pooling import pool_pages_fused

    def fn(model, patches):
        vecs, _ = model.encode_pages(patches)
        vis = vecs[:, cfg.n_special:]
        mask = torch.ones(vis.shape[:2], dtype=torch.float32,
                          device=vis.device)
        # ``repro`` calls the plain ``pool_ref`` here; the wrapper launches
        # ``csrc/pool.cu`` on the card and runs ``pool_ref`` on the CPU
        pooled = pool_pages_fused(vis, mask, pm)
        glob = vis.mean(dim=1)
        return (vis.to(torch.bfloat16), pooled.to(torch.bfloat16),
                glob.to(torch.bfloat16))

    return fn


def _retriever_mesh_cell(arch, shape, cfg, mesh, dev, fill, make,
                         n_raw) -> Cell:
    """The retriever's train and index cells data-parallel over ``mesh``:
    the encoder replicated, pages and queries split over dp. Training
    keeps global in-batch negatives (``ColXEncoder.contrastive_loss``
    with the policy); indexing pools through ``pool.cu`` on every
    position."""
    from repro_torch.models import late_interaction as LI

    pol = ShardingPolicy(mesh)
    with torch.device("meta"):
        tmpl = LI.init_params(cfg, None, "meta")
    lmap = PL.leaf_map(tmpl)
    pshard = {n: pol.named() for n in tmpl.jax_leaf_names()}
    with _building(dev):
        params = _placed_params(tmpl, pshard, fill, make)
    pspecs = SM.in_specs_of(pshard)
    dp_spec = pol.spec("dp", None, None)

    if shape.kind == "train":
        B = shape.global_batch
        body_pol = pol.body(batch=B)

        def loss(p, b):
            return PL.local_module(tmpl, p, lmap).contrastive_loss(
                b, body_pol)

        batch = {"patches": fill.normal((B, n_raw, LI.D_PATCH)),
                 "query_tokens": fill.ids((B, cfg.max_query_tokens),
                                          cfg.query_vocab),
                 "query_mask": fill.ones((B, cfg.max_query_tokens))}
        bshard = {k: pol.named("dp", *([None] * (v.ndim - 1)))
                  for k, v in batch.items()}
        step, args = _placed_train(loss, OPT.OptConfig(), params, batch,
                                   bshard, mesh)
        flops = 12.0 * cfg.n_layers * cfg.d_model * cfg.d_model * 3 \
            * B * cfg.seq_len
        return Cell(arch, shape.name, step, args, donate=(0, 1),
                    model_flops=flops)

    from repro_torch.kernels.pooling import pooling_matrix
    B = shape.pages_per_step
    pm = torch.as_tensor(pooling_matrix(cfg)).to(dev)

    @torch.no_grad()
    def body(p, patches, pm_):
        return _index_fn(cfg, pm_)(PL.local_module(tmpl, p, lmap), patches)

    fn_ = SM.shard_map(body, mesh, (pspecs, dp_spec, SM.P()),
                       (dp_spec, dp_spec, pol.spec("dp", None)))
    patches = device_put(fill.normal((B, n_raw, LI.D_PATCH)),
                         pol.named("dp", None, None), copy=True)
    flops = 12.0 * cfg.n_layers * cfg.d_model * cfg.d_model * B * cfg.seq_len
    return Cell(arch, shape.name, lambda p, x: fn_(p, x, pm),
                (params, patches), model_flops=flops / 3.0)


def search_stages(shape, variant: str) -> tuple:
    """The search cell's cascade: ``stage1`` the exact 1-stage search,
    else the paper's 2-stage one, scanning and reranking through the
    kernels (on the card; the plain versions on the CPU)."""
    from repro_torch.core import multistage as MST
    if variant == "stage1":
        stages = MST.one_stage(shape.top_k)
    else:
        stages = MST.two_stage(shape.prefetch_k, shape.top_k)
    return MST.with_rerank_policy(
        MST.with_scan_policy(stages, use_kernel=True), rerank_kernel=True)


def build_retriever_cell(arch: str, shape, device=None,
                         variant: str = "base", generator=None,
                         mesh=None, stages=None) -> Cell:
    """A ColX cell: train, index, or search over a synthetic corpus.
    ``stages`` sets a search cell's cascade; ``None`` keeps the variant's
    (``search_stages``: 1-stage for "stage1", else 2-stage)."""
    from repro_torch.models import late_interaction as LI

    cfg = get_config(arch)
    dev, gen, fill = _setup(device, generator, mesh)
    n_raw = cfg.n_patches * (4 if cfg.geometry == "dynamic" else 1)

    def model_of():
        with _building(dev):
            return LI.init_params(cfg, gen, dev)

    if mesh is not None and shape.kind != "search":
        return _retriever_mesh_cell(arch, shape, cfg, mesh, dev, fill,
                                    model_of, n_raw)

    if shape.kind == "train":
        B = shape.global_batch
        model = model_of()
        oc = OPT.OptConfig()
        opt_state, labels = _train_state(model, oc)
        step = make_train_step(lambda m, b: m.contrastive_loss(b), oc,
                               labels=labels)
        batch = {"patches": fill.normal((B, n_raw, LI.D_PATCH)),
                 "query_tokens": fill.ids((B, cfg.max_query_tokens),
                                          cfg.query_vocab),
                 "query_mask": fill.ones((B, cfg.max_query_tokens))}
        flops = 12.0 * cfg.n_layers * cfg.d_model * cfg.d_model * 3 \
            * B * cfg.seq_len
        return Cell(arch, shape.name, step, (model, opt_state, batch),
                    donate=(0, 1), model_flops=flops)

    if shape.kind == "index":
        from repro_torch.kernels.pooling import pooling_matrix
        B = shape.pages_per_step
        model = model_of()
        pm = torch.as_tensor(pooling_matrix(cfg)).to(dev)
        flops = 12.0 * cfg.n_layers * cfg.d_model * cfg.d_model \
            * B * cfg.seq_len
        return Cell(arch, shape.name, _index_fn(cfg, pm),
                    (model, fill.normal((B, n_raw, LI.D_PATCH))),
                    model_flops=flops / 3.0)

    # search over the corpus on one device, or split over the mesh's
    # positions (the corpus padded to a multiple of them)
    # variants: "stage1" = pre-paper exact-scan baseline; "base" = the
    # paper's 2-stage cascade; "opt" = 2-stage + int8 scan storage.
    from repro_torch.kernels.maxsim.ops import quantize_int8
    from repro_torch.retrieval.engine import make_search_fn
    from repro_torch.retrieval.store import codes_key, mask_key, scale_key
    ndev = n_devices(mesh) if mesh is not None else 1
    N, Bq = -(-shape.corpus // ndev) * ndev, shape.query_batch
    stages = search_stages(shape, variant) if stages is None \
        else tuple(stages)
    Dfull, Dp, d = cfg.n_patches, cfg.n_pooled, cfg.out_dim
    store = {
        "initial": fill.unit((N, Dfull, d), torch.bfloat16),
        mask_key("initial"): fill.ones((N, Dfull)),
        "mean_pooling": fill.unit((N, Dp, d), torch.bfloat16),
        mask_key("mean_pooling"): fill.ones((N, Dp)),
        "global_pooling": fill.unit((N, d), torch.bfloat16),
    }
    if variant == "opt":
        first = stages[0].vector
        if fill.meta:
            codes = torch.empty(store[first].shape, dtype=torch.int8,
                                device=dev)
            scales = torch.empty(store[first].shape[:-1],
                                 dtype=torch.float32, device=dev)
        else:
            codes, scales = quantize_int8(store[first], chunk=8192)
        store[codes_key(first)] = codes
        store[scale_key(first)] = scales
    q = fill.unit((Bq, 32, d), torch.float32)
    qm = fill.ones((Bq, 32), torch.float32)
    # stage-1 madds + rerank madds (Eq. 1)
    flops = 2.0 * Bq * 32 * d * (N * Dp + shape.prefetch_k * Dfull)
    return Cell(arch, shape.name, make_search_fn(stages, N, mesh),
                (store, q, qm),
                model_flops=flops,
                note=f"stages={[s.vector for s in stages]}")


# ===========================================================================
# dispatch
# ===========================================================================

VARIANTS = ("base", "opt")
SEARCH_VARIANTS = ("base", "opt", "stage1")


def variants(arch: str, shape_name: str) -> tuple:
    """The variants ``repro``'s cells are built at: base and opt, and
    the exact 1-stage search for a retriever's search cell."""
    kind = get_shapes(arch)[shape_name].kind
    return SEARCH_VARIANTS if kind == "search" else VARIANTS


def build_cell(arch: str, shape_name: str, device=None,
               variant: str = "base", generator=None, mesh=None) -> Cell:
    """variant="base": the paper-faithful step.
    variant="opt": ``repro``'s beyond-baseline set:
      - MoE archs: ragged sorted dispatch instead of dense all-experts
      - equiformer: fused rotate+truncate / expand+rotate-back
      - recsys retrieval_cand: the paper's 2-stage prefetch->rerank
      - retriever search: int8 scan stage (+ the 2-stage cascade)
    ``device`` defaults to the card (and raises without one), or with
    ``mesh`` to the mesh's first device; ``meta`` sizes a cell without
    allocating it. ``mesh`` runs the cell over it: partitioned, its
    arguments placed by ``repro``'s ``in_shardings``, or through its
    explicit per-shard bodies (module docstring); every cell builds on a
    mesh."""
    cfg = get_config(arch)
    shape = get_shapes(arch)[shape_name]
    fam = cfg.family
    by_family = {"lm": build_lm_cell, "gnn": build_gnn_cell,
                "recsys": build_recsys_cell,
                "retriever": build_retriever_cell}
    if fam in by_family:
        return by_family[fam](arch, shape, device, variant, generator, mesh)
    raise ValueError(fam)
