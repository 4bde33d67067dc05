"""The recsys family: dcn-v2, autoint, bert4rec, dlrm-mlperf (the port of
``repro.models.recsys.nets``).

- dcn-v2       : cross network (x_{l+1} = x0 * (W x_l + b) + x_l), stacked MLP
- autoint      : multi-head self-attention over field embeddings
- bert4rec     : bidirectional transformer over item history, sampled softmax
- dlrm-mlperf  : bottom MLP + dot interaction + top MLP (Criteo-1TB layout)

``RecsysModel`` holds one arch's parameters under ``repro``'s names: the
embedding tables in ``emb`` (``big``, ``small``), bert4rec's item table in
``items``, so ``training.optimizer.default_labels`` gives the tables the
row-wise Adagrad, as ``repro``'s does; lists of layers are
``nn.ModuleList``s of ``nn.ParameterDict``s (``cross.0.w``). The forward
functions keep ``repro``'s names and take the model in place of the
params tree. ``param_specs`` gives each parameter the logical axes
``repro``'s cells place it by (the big embedding table and bert4rec's
item table row-sharded over tp, the rest replicated).

``retrieval_step`` is the paper's multi-stage search on 10^6 candidates:
a truncated-dim (Matryoshka-style) proxy prefetches ``prefetch_k``
candidates, the full model reranks them exactly; ``stages=1`` scores every
candidate with the full model. With ``two_level_topk`` and a ``shard``
policy whose mesh has more than one position along ``flat``, each
selection over the candidates is ``repro``'s two-level top-k: a top-k per
position over its slab of the scores, then a merge of the S x k (score,
id) pairs. Selection is ``top_k``'s stable sort (equal scores keep the
lower index first, ``jax.lax.top_k``'s order). Products run in float32
with TF32 off (``full_f32``).

Partitioned (a ``shard`` policy inside a ``shard_map`` body, as the cells
run them on their placed slabs): the model holds this position's slabs,
the big embedding table and bert4rec's item table split by rows over tp
(``embedding.take_split_rows``), and the batch is this position's block.
``repro``'s ``shard.constrain`` sites stay where it has them; the body's
blocks already lie as they name, so each is the identity there. A batch
is split over dp, and the losses are global means (local sums ``psum``'d
over dp, over the global count). In ``retrieval_step`` the candidates
(and ``cand_proxy``) are this position's block over ``flat`` and are
scored where they lie: the query's encoding and the rerank of the
prefetched ids run whole on every position; the selections read the
scores on their positions (``_topk``: one gathered ``top_k``, or the
two-level merge of each position's top-k); the prefetched candidates'
ids are gathered from their owners.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import shard_map as SM
from repro_torch.kernels.dispatch import full_f32, resolve_device
from repro_torch.kernels.maxsim.ref import top_k as sorted_top_k
from repro_torch.models.layers import _gelu, _normal, partitioned
from repro_torch.models.recsys import embedding as EMB
from repro_torch.models.recsys.embedding import take_rows


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _dense(gen, shape, device) -> nn.Parameter:
    return nn.Parameter(_normal(gen, shape, shape[0] ** -0.5, device))


def _zeros(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=torch.float32, device=device))


def mlp_params(gen, dims: tuple, device) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ParameterDict({"w": _dense(gen, (a, b), device),
                          "b": _zeros(b, device)})
        for a, b in zip(dims[:-1], dims[1:]))


def mlp_apply(layers, x: torch.Tensor, final_act: bool = False):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             shard=None) -> torch.Tensor:
    """The mean binary cross-entropy; inside a body over the global batch
    (the local sum ``psum``'d over dp, over the global count)."""
    z, y = logits.float(), labels.float()
    per = (torch.maximum(z, torch.zeros_like(z)) - z * y
           + torch.log1p(torch.exp(-torch.abs(z))))
    if not partitioned(shard):
        return torch.mean(per)
    dp = shard.axes("dp")
    return SM.psum(per.sum(), dp) / SM.psum(float(per.numel()), dp)


def layout_of(cfg) -> EMB.EmbeddingLayout:
    return EMB.EmbeddingLayout(tuple(cfg.vocab_sizes), cfg.embed_dim)


def rows_over(shard, axes: tuple):
    """A body policy whose batch axis ``dp`` names the mesh axes ``axes``:
    the candidates' rows over ``flat``, or () for rows that every position
    holds whole (one query, the prefetched candidates)."""
    out = shard.body()
    out.rules = dict(shard.rules, dp=tuple(axes))
    return out


def _jax_key(name: str) -> tuple:
    """Sort key of a parameter name in ``jax.tree.leaves`` order: dict keys
    sorted, list entries by index."""
    return tuple(int(c) if c.isdigit() else c for c in name.split("."))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class RecsysModel(nn.Module):
    """The recsys model of ``cfg`` (a ``RecsysConfig``), its parameters
    named as ``repro``'s tree:

    - dcn-v2: ``emb``, ``cross`` [{w, b}], ``mlp`` [{w, b}], ``out``
    - autoint: ``emb``, ``layers`` [{wq, wk, wv, wr}], ``out``
    - bert4rec: ``items``, ``pos``, ``blocks`` [{ln1, wq, wk, wv, wo, ln2,
      w1, b1, w2, b2}], ``ln_f``
    - dlrm-mlperf: ``emb``, ``bot`` [{w, b}], ``top`` [{w, b}]

    Weights are drawn from ``generator`` on its device (a CPU generator
    draws on the host, then the model moves to ``device``) with
    ``repro``'s scales: dense weights normal x ``shape[0] ** -0.5``
    (bert4rec's ``items`` and ``pos`` too, as ``repro`` draws them),
    embedding tables normal x ``embed_dim ** -0.5``, biases and norms
    zero. ``device`` defaults to the card and raises without one."""

    def __init__(self, cfg, generator: torch.Generator | None = None,
                 device="cuda", n_shards: int = 1):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        g = generator
        if cfg.name == "dcn-v2":
            self.emb = EMB.init_embedding(layout_of(cfg), g, dev, n_shards)
            d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
            self.cross = nn.ModuleList(
                nn.ParameterDict({"w": _dense(g, (d0, d0), dev),
                                  "b": _zeros(d0, dev)})
                for _ in range(cfg.n_cross_layers))
            self.mlp = mlp_params(g, (d0,) + tuple(cfg.mlp), dev)
            self.out = mlp_params(g, (cfg.mlp[-1], 1), dev)
        elif cfg.name == "autoint":
            self.emb = EMB.init_embedding(layout_of(cfg), g, dev, n_shards)
            d, da, H = cfg.embed_dim, cfg.d_attn, cfg.n_heads
            layers, din = [], d
            for _ in range(cfg.n_attn_layers):
                layers.append(nn.ParameterDict({
                    "wq": _dense(g, (din, H, da), dev),
                    "wk": _dense(g, (din, H, da), dev),
                    "wv": _dense(g, (din, H, da), dev),
                    "wr": _dense(g, (din, H * da), dev)}))
                din = H * da       # concat-heads output feeds the next layer
            self.layers = nn.ModuleList(layers)
            self.out = mlp_params(g, (cfg.n_sparse * H * da, 1), dev)
        elif cfg.name == "bert4rec":
            d = cfg.embed_dim
            # +1 for [MASK]; rows padded to a multiple of 256 as in repro
            rows = -(-(cfg.n_items + 1) // 256) * 256
            self.items = _dense(g, (rows, d), dev)
            self.pos = _dense(g, (cfg.seq_len, d), dev)
            self.blocks = nn.ModuleList(nn.ParameterDict({
                "ln1": _zeros(d, dev),
                "wq": _dense(g, (d, d), dev), "wk": _dense(g, (d, d), dev),
                "wv": _dense(g, (d, d), dev), "wo": _dense(g, (d, d), dev),
                "ln2": _zeros(d, dev),
                "w1": _dense(g, (d, 4 * d), dev), "b1": _zeros(4 * d, dev),
                "w2": _dense(g, (4 * d, d), dev), "b2": _zeros(d, dev),
            }) for _ in range(cfg.n_blocks))
            self.ln_f = _zeros(d, dev)
        elif cfg.name == "dlrm-mlperf":
            self.emb = EMB.init_embedding(layout_of(cfg), g, dev, n_shards)
            n_vec = cfg.n_sparse + 1
            top_in = n_vec * (n_vec - 1) // 2 + cfg.embed_dim
            self.bot = mlp_params(g, (cfg.n_dense,) + tuple(cfg.bot_mlp), dev)
            self.top = mlp_params(g, (top_in,) + tuple(cfg.top_mlp), dev)
        else:
            raise ValueError(cfg.name)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ------------------------------------------------------------------
    # ``repro``'s parameter tree (lists of dicts, nothing stacked)
    # ------------------------------------------------------------------

    def jax_leaf_names(self) -> list:
        """Paths of ``repro``'s params tree in ``jax.tree.leaves`` order,
        '/'-joined (``cross/0/w``, ``emb/big``, ``blocks/1/wq``)."""
        names = sorted((n for n, _ in self.named_parameters()), key=_jax_key)
        return [n.replace(".", "/") for n in names]

    def jax_stacked(self, name: str) -> bool:
        """No leaf of a recsys tree is stacked over layers."""
        return False

    def jax_leaf_params(self, name: str) -> list:
        """The one parameter behind a ``repro`` leaf."""
        return [self.get_parameter(name.replace("/", "."))]

    @torch.no_grad()
    def to_jax_leaves(self) -> list:
        """The parameters as ``repro``'s leaves, in ``jax.tree.leaves``
        order."""
        return [self.jax_leaf_params(n)[0].detach().clone()
                for n in self.jax_leaf_names()]

    @torch.no_grad()
    def load_jax_leaves(self, leaves) -> None:
        """Copy ``repro``-ordered leaves (numpy arrays or tensors) into the
        parameters, bit for bit; shapes must match."""
        names = self.jax_leaf_names()
        if len(leaves) != len(names):
            raise ValueError(f"{len(leaves)} leaves, the model has "
                             f"{len(names)}")
        for name, x in zip(names, leaves):
            x = torch.as_tensor(x)
            p = self.jax_leaf_params(name)[0]
            if tuple(x.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(x.shape)}, the "
                                 f"model has {tuple(p.shape)}")
            p.copy_(x)


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda", n_shards: int = 1) -> RecsysModel:
    """A randomly initialised model (``repro``'s ``init_params``; the draws
    come from ``generator``, not from a JAX key); the big embedding
    table's rows padded to a multiple of ``n_shards``."""
    return RecsysModel(cfg, generator, device, n_shards)


def _row_sharded(cfg, name: str) -> bool:
    keys = name.split(".")
    return "big" in keys or (cfg.name == "bert4rec" and "items" in keys)


def param_specs(cfg, model) -> dict:
    """Logical axes of each parameter of ``model`` by name, as ``repro``'s
    cells place its params: the big embedding table (and bert4rec's item
    table) row-sharded over tp, every other leaf replicated (``()``)."""
    return {n: (("tp",) + (None,) * (p.ndim - 1) if _row_sharded(cfg, n)
                else ()) for n, p in model.named_parameters()}


def _tree_get(tree, name: str):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def params_from_jax(cfg, tree: dict, device="cuda") -> RecsysModel:
    """A model holding ``repro``'s params ``tree`` (nested dicts and lists
    of numpy arrays) bit for bit."""
    model = RecsysModel(cfg, torch.Generator().manual_seed(0), device)
    model.load_jax_leaves([_tree_get(tree, n)
                           for n in model.jax_leaf_names()])
    return model


def to_jax_leaves(model: RecsysModel) -> list:
    """``model``'s parameters as ``repro``'s leaves (``jax.tree.leaves``
    order of ``init_params``' tree)."""
    return model.to_jax_leaves()


# ---------------------------------------------------------------------------
# DCN-v2, AutoInt, DLRM
# ---------------------------------------------------------------------------

def dcn_forward(cfg, model, dense, sparse_idx, shard=None):
    emb = EMB.lookup(model.emb, sparse_idx, shard)
    B = dense.shape[0]
    x0 = torch.cat([dense, emb.reshape(B, -1)], dim=-1)
    x = x0
    for l in model.cross:
        x = x0 * (x @ l["w"] + l["b"]) + x
    h = mlp_apply(model.mlp, x, final_act=True)
    return mlp_apply(model.out, h)[:, 0]


def autoint_forward(cfg, model, dense, sparse_idx, shard=None):
    x = EMB.lookup(model.emb, sparse_idx, shard)          # [B, F, d]
    for l in model.layers:
        q = torch.einsum("bfd,dhk->bfhk", x, l["wq"])
        k = torch.einsum("bfd,dhk->bfhk", x, l["wk"])
        v = torch.einsum("bfd,dhk->bfhk", x, l["wv"])
        a = torch.softmax(torch.einsum("bfhk,bghk->bhfg", q, k)
                          / math.sqrt(q.shape[-1]), dim=-1)
        o = torch.einsum("bhfg,bghk->bfhk", a, v)
        o = o.reshape(x.shape[:2] + (-1,))
        x = torch.relu(o + torch.einsum("bfd,dk->bfk", x, l["wr"]))
    B = x.shape[0]
    return mlp_apply(model.out, x.reshape(B, -1))[:, 0]


def dlrm_forward(cfg, model, dense, sparse_idx, shard=None):
    emb = EMB.lookup(model.emb, sparse_idx, shard)        # [B, 26, 128]
    dv = mlp_apply(model.bot, dense, final_act=True)      # [B, 128]
    vecs = torch.cat([dv[:, None, :], emb], dim=1)        # [B, 27, 128]
    B, n = vecs.shape[:2]
    gram = torch.bmm(vecs, vecs.transpose(1, 2))
    # np.triu_indices(n, k=1)'s order, made on the device
    iu, ju = torch.triu_indices(n, n, offset=1, device=vecs.device)
    inter = gram.reshape(B, n * n)[:, iu * n + ju]        # [B, 351]
    x = torch.cat([inter, dv], dim=-1)
    return mlp_apply(model.top, x)[:, 0]


# ---------------------------------------------------------------------------
# BERT4Rec
# ---------------------------------------------------------------------------

def _b4r_norm(x, w, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + w)


def _b4r_block(cfg, b, x, amask):
    d, H = cfg.embed_dim, cfg.n_heads
    h = _b4r_norm(x, b["ln1"])
    q = (h @ b["wq"]).reshape(*h.shape[:2], H, d // H)
    k = (h @ b["wk"]).reshape(*h.shape[:2], H, d // H)
    v = (h @ b["wv"]).reshape(*h.shape[:2], H, d // H)
    s = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(d // H)
    s = s.masked_fill(~amask[:, None], -1e30)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhst,bthk->bshk", a, v).reshape(h.shape)
    x = x + o @ b["wo"]
    h = _b4r_norm(x, b["ln2"])
    return x + _gelu(h @ b["w1"] + b["b1"]) @ b["w2"] + b["b2"]


def items_of(model, ids: torch.Tensor, shard=None, rows=None):
    """Rows of bert4rec's item table; inside a body the table is this
    position's row slab over tp, the ids split over ``rows`` (default the
    batch's axes)."""
    if not partitioned(shard):
        return take_rows(model.items, ids)
    rows = shard.axes("dp") if rows is None else rows
    return EMB.take_split_rows(model.items, ids, shard, rows)


def bert4rec_encode(cfg, model, seq, seq_mask, shard=None):
    """seq [B,S] item ids (n_items = [MASK]) -> hidden [B,S,d]. Each block
    runs under ``torch.utils.checkpoint`` when gradients are on (``repro``
    wraps it in ``jax.checkpoint``); S must be ``cfg.seq_len``."""
    full_f32()
    x = items_of(model, seq, shard) + model.pos
    if shard is not None:
        x = shard.constrain(x, "dp", None, None, have=("dp", None, None))
    amask = seq_mask[:, None, :] & seq_mask[:, :, None]
    for b in model.blocks:
        if torch.is_grad_enabled():
            x = SM.checkpoint(_b4r_block, cfg, b, x, amask)
        else:
            x = _b4r_block(cfg, b, x, amask)
    return _b4r_norm(x, model.ln_f)


def take_along(h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(h, pos[..., None], axis=1)``: h [B, S, d], pos
    [B, M] -> [B, M, d]; positions in [-S, 0) wrap, others outside [0, S)
    give NaN rows."""
    S = h.shape[1]
    pos = torch.where(pos < 0, pos + S, pos)
    bad = (pos < 0) | (pos >= S)
    idx = pos.masked_fill(bad, 0)[..., None].expand(-1, -1, h.shape[-1])
    return torch.gather(h, 1, idx).masked_fill(bad[..., None], float("nan"))


def bert4rec_mlm_loss(cfg, model, batch, shard=None):
    """Masked-item prediction with sampled softmax over ``neg_samples``
    (shared by the batch); inside a body the mean over the global batch's
    masked slots."""
    h = bert4rec_encode(cfg, model, batch["seq"], batch["seq_mask"], shard)
    hm = take_along(h, batch["mlm_positions"])           # [B, M, d]
    wpos = items_of(model, batch["mlm_labels"], shard)    # [B, M, d]
    wneg = items_of(model, batch["neg_samples"], shard, rows=())  # [K, d]
    s_pos = torch.sum(hm * wpos, dim=-1)                  # [B, M]
    s_neg = torch.einsum("bmd,kd->bmk", hm, wneg)         # [B, M, K]
    logits = torch.cat([s_pos[..., None], s_neg], dim=-1)
    logz = torch.logsumexp(logits, dim=-1)
    ce = logz - s_pos
    m = batch["mlm_mask"].to(torch.float32)
    num, den = torch.sum(ce * m), torch.sum(m)
    if partitioned(shard):
        num, den = SM.psum((num, den), shard.axes("dp"))
    return num / torch.clamp(den, min=1.0)


def bert4rec_query(cfg, model, seq, seq_mask, shard=None):
    """Encoded user vector = hidden at the last valid position. [B, d]."""
    h = bert4rec_encode(cfg, model, seq, seq_mask, shard)
    last = torch.clamp(seq_mask.to(torch.int64).sum(dim=1) - 1, min=0)
    return torch.gather(h, 1, last[:, None, None].expand(-1, 1, h.shape[-1])
                        )[:, 0]


# ---------------------------------------------------------------------------
# family dispatch + steps
# ---------------------------------------------------------------------------

def ctr_forward(cfg, model, batch, shard=None):
    full_f32()
    if cfg.name == "dcn-v2":
        return dcn_forward(cfg, model, batch["dense"], batch["sparse"],
                           shard)
    if cfg.name == "autoint":
        return autoint_forward(cfg, model, batch.get("dense"),
                               batch["sparse"], shard)
    if cfg.name == "dlrm-mlperf":
        return dlrm_forward(cfg, model, batch["dense"], batch["sparse"],
                            shard)
    raise ValueError(cfg.name)


def loss_fn(cfg, model, batch, shard=None):
    if cfg.name == "bert4rec":
        return bert4rec_mlm_loss(cfg, model, batch, shard)
    return bce_loss(ctr_forward(cfg, model, batch, shard), batch["labels"],
                    shard)


@torch.no_grad()
def serve_step(cfg, model, batch, chunk: int = 32768, shard=None):
    """Batched inference: CTR probabilities [B], or bert4rec's scores of
    each row's ``slate`` [B, K]. A batch of more than ``chunk`` rows that
    ``chunk`` divides runs chunk by chunk (``repro``'s ``lax.map``), so
    activation memory stays bounded; any other batch is one call. Inside
    a body the batch is this position's rows, chunked alike (rows are
    independent, so the outputs are the global batch's)."""
    def one(b):
        if cfg.name == "bert4rec":
            q = bert4rec_query(cfg, model, b["seq"], b["seq_mask"], shard)
            return torch.einsum("bd,bkd->bk", q,
                                items_of(model, b["slate"], shard))
        return torch.sigmoid(ctr_forward(cfg, model, b, shard))

    B = next(v for v in batch.values() if v is not None).shape[0]
    if B <= chunk or B % chunk:
        return one(batch)
    return torch.cat([one({k: (v[i:i + chunk] if v is not None else None)
                           for k, v in batch.items()})
                      for i in range(0, B, chunk)])


# ---------------------------------------------------------------------------
# retrieval_cand: the paper's multi-stage search on 10^6 candidates
# ---------------------------------------------------------------------------

def _item_field(cfg) -> int:
    return (int(np.argmax(np.asarray(cfg.vocab_sizes))) if cfg.vocab_sizes
            else 0)


# candidates the full CTR model scores in one call: ``repro`` scores all N
# at once over its mesh; on one card autoint's q, k and v alone would take
# 30 GB at N = 10^6, so the port scores them in serve_step's chunks
CAND_CHUNK = 32768


def _topk(scores: torch.Tensor, k: int, shard=None,
          two_level: bool = False) -> tuple:
    """Top-k over the candidates' scores.

    two_level=False: ``top_k`` over the whole score vector.
    two_level=True (over a mesh with S > 1 positions along ``flat`` that
    divide the N scores): inside ``shard_map`` each position takes the
    top min(k, N/S) of its slab with global ids, and the S x k (score,
    id) pairs are merged on the mesh's first device; equal scores keep
    the lower id, as ``jax.lax.top_k`` keeps them.
    Inside a body ``scores`` is this position's block over ``flat``
    (``_topk_placed``).
    """
    if partitioned(shard):
        return _topk_placed(scores, k, shard, two_level)
    n = scores.shape[0]
    s = shard.axis_size("flat") if shard is not None else 1
    if not two_level or s <= 1 or n % s:
        return sorted_top_k(scores, k)
    flat = shard._resolve("flat")
    kk = min(k, n // s)

    def local(seg):
        v, i = sorted_top_k(seg, kk)
        return v[None], (i + SM.axis_index(flat) * (n // s))[None]

    P = SM.P
    v, gid = SM.shard_map(local, shard.mesh, in_specs=P(flat),
                          out_specs=(P(flat, None), P(flat, None)))(scores)
    v2, j = sorted_top_k(v.reshape(-1), k)
    return v2, gid.reshape(-1)[j]


def _topk_placed(scores: torch.Tensor, k: int, shard,
                 two_level: bool) -> tuple:
    """``_topk`` inside a body, ``scores`` this position's block of the N
    over ``flat`` (global ids: the block's offset plus its index).
    two_level=False: the blocks gathered over ``flat`` in order and one
    ``top_k`` over all N, ``repro``'s ``lax.top_k`` of the whole vector;
    two_level=True: this position's top min(k, N/S), then the S x k
    (score, id) pairs gathered and merged. Every position returns the
    result."""
    flat = shard.axes("flat")
    if not two_level:
        return sorted_top_k(SM.all_gather(scores, flat, axis=0, tiled=True),
                            k)
    n = scores.shape[0]
    v, i = sorted_top_k(scores, min(k, n))
    gid = i + SM.axis_index(flat) * n
    v2, j = sorted_top_k(SM.all_gather(v, flat, axis=0, tiled=True), k)
    return v2, SM.all_gather(gid, flat, axis=0, tiled=True)[j]


def _ids_at(cand: torch.Tensor, pre: torch.Tensor, shard) -> torch.Tensor:
    """``cand[pre]`` for global indices ``pre`` (the same on every
    position); inside a body ``cand`` is this position's block over
    ``flat`` and each id comes from its owner (the others add 0)."""
    if not partitioned(shard):
        return cand[pre]
    flat = shard.axes("flat")
    n = cand.shape[0]
    loc = pre - SM.axis_index(flat) * n
    ok = (loc >= 0) & (loc < n)
    got = cand[loc.clamp(0, n - 1)]
    return SM.psum(torch.where(ok, got, torch.zeros_like(got)), flat)


@torch.no_grad()
def retrieval_step(cfg, model, batch, *, stages: int = 2,
                   prefetch_k: int = 256, top_k: int = 100,
                   d_proxy: int = 16, two_level_topk: bool = False,
                   shard=None) -> tuple:
    """Score 1 query against N candidates; return (scores, ids) of top_k.

    stages=1: exact full-model scoring of every candidate (baseline).
    stages=2: truncated-dim proxy prefetch -> exact rerank of top-K
              (the paper's multi-stage retrieval, Matryoshka stage 1);
              ``batch["cand_proxy"]`` [N, d_proxy], when given, is the
              stage-1 proxy table in place of the item rows' prefixes.
    The CTR models score candidates ``CAND_CHUNK`` at a time.
    ``two_level_topk`` selects over the candidates with the two-level
    top-k over ``shard``'s mesh (``_topk``). Inside a body the
    candidates and ``cand_proxy`` are this position's block over
    ``flat`` (module docstring).
    """
    full_f32()
    cand = batch["candidates"]                         # [N] item ids
    whole = over = shard
    if partitioned(shard):
        whole, over = rows_over(shard, ()), rows_over(shard,
                                                      shard.axes("flat"))

    def placed(s):                                     # repro's constraint
        return s if shard is None else shard.constrain(s, "flat",
                                                       have=("flat",))

    if cfg.name == "bert4rec":
        q = bert4rec_query(cfg, model, batch["seq"], batch["seq_mask"],
                           whole)[0]

        def exact(ids, pol):
            return items_of(model, ids, pol) @ q

        if stages == 1:
            return _topk(placed(exact(cand, over)), top_k, shard,
                         two_level_topk)
        if "cand_proxy" in batch:
            vec_p = batch["cand_proxy"]
        else:
            vec_p = items_of(model, cand, over)[:, :d_proxy]
        _, pre = _topk(placed(vec_p @ q[:d_proxy]), prefetch_k, shard,
                       two_level_topk)
        sc, ix = sorted_top_k(exact(_ids_at(cand, pre, shard), whole),
                              top_k)
        return sc, pre[ix]

    # CTR models: user context broadcast over the candidate item field
    fld = _item_field(cfg)
    base_sparse = batch["sparse"][0]                   # [n_sparse]
    dense = batch["dense"][0] if batch.get("dense") is not None else None

    def scores_of(ids, pol):
        n = ids.shape[0]
        sp = base_sparse.expand(n, -1).clone()
        sp[:, fld] = ids
        de = dense.expand(n, -1) if dense is not None else None
        return ctr_forward(cfg, model, {"dense": de, "sparse": sp}, pol)

    def full_scores(ids, pol):
        return torch.cat([scores_of(ids[i:i + CAND_CHUNK], pol)
                          for i in range(0, ids.shape[0], CAND_CHUNK)])

    if stages == 1:
        return _topk(placed(full_scores(cand, over)), top_k, shard,
                     two_level_topk)
    # stage 1: truncated-dim dot between user-context proxy and item embeds
    uvec = EMB.lookup(model.emb, base_sparse[None], whole)[0]
    uq = uvec.mean(dim=0)[:d_proxy]                    # [d_proxy]
    if "cand_proxy" in batch:
        ivecs = batch["cand_proxy"]
    else:
        ivecs = _field_embedding(model.emb, fld, cand, over)[:, :d_proxy]
    _, pre = _topk(placed(ivecs @ uq), prefetch_k, shard, two_level_topk)
    sc, ix = sorted_top_k(full_scores(_ids_at(cand, pre, shard), whole),
                          top_k)
    return sc, pre[ix]


def _field_embedding(emb, fld: int, ids: torch.Tensor,
                     shard=None) -> torch.Tensor:
    """Rows of field ``fld`` for its local ``ids`` from the table that
    holds it (inside a body, ``big`` by ``take_split_rows``)."""
    layout = emb.layout
    part = "big" if fld in layout.big_fields else "small"
    fields = getattr(layout, f"{part}_fields")
    offs, _ = layout.offsets(fields)
    off = int(offs[list(fields).index(fld)])
    if part == "big" and partitioned(shard):
        return EMB.take_split_rows(emb.big, ids + off, shard,
                                   shard.axes("dp"))
    return take_rows(getattr(emb, part), ids + off)
