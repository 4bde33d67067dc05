"""KV caches for decode: per segment x slot, ring-buffered windows (the
port of ``repro.models.kv_cache``).

Layers are organised into segments of ``reps`` repetitions of an attention
pattern (``transformer.segment_plan``). Sliding-window slots allocate only
``min(window, seq)`` positions: a ring buffer, which attention reads in
any order because RoPE is applied to K before it is cached. With
``windowed=False`` every slot holds the full length and a window layer's
decode masks its keys by position instead (``layers.attention``); the
logits are the ring's. (``repro``'s decode over such a cache attends to
every earlier position once a key lies a window or more back, which its
ring does not: a difference by design.) ``cache_specs`` describes the caches
without allocating them (meta tensors, the counterpart of ``repro``'s
``ShapeDtypeStruct`` tree) and ``cache_logical_axes`` gives each cache
leaf its logical sharding axes, as ``repro``'s do, and ``cache_shardings``
resolves them on a mesh: a placed cache (``Sharded`` slabs) is what the
partitioned prefill returns and decode writes in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import resolve_device


def cache_len(window: int, seq_len: int, windowed: bool = True) -> int:
    """Slots of one layer's cache: a ring of ``min(window, seq_len)``
    for a window layer when ``windowed``, else ``seq_len``."""
    if windowed and window:
        return min(window, seq_len)
    return seq_len


def init_cache(cfg, plan, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda", seq_shards: int = 1,
               windowed: bool = True) -> list:
    """Returns [segments][slots] of {"k","v"}: zeros [reps, B, Sc, kv, hd]
    of ``dtype`` on ``device``. ``seq_shards`` gives one position's slab of
    a cache split over the sequence (``cache_logical_axes``): Sc /
    seq_shards slots. ``windowed`` as in ``cache_len``."""
    dev = resolve_device(device)
    segs = []
    for reps, windows in plan:
        slots = []
        for w in windows:
            sc = cache_len(w, seq_len, windowed)
            if sc % seq_shards:
                raise ValueError(f"a cache of {sc} slots does not split "
                                 f"over {seq_shards} positions")
            sc //= seq_shards
            shape = (reps, batch, sc, cfg.n_kv_heads, cfg.head_dim)
            slots.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                          "v": torch.zeros(shape, dtype=dtype, device=dev)})
        segs.append(slots)
    return segs


def cache_specs(cfg, plan, batch: int, seq_len: int,
                dtype=torch.bfloat16, windowed: bool = True) -> list:
    """``init_cache``'s tree as storage-free ``meta`` tensors."""
    segs = []
    for reps, windows in plan:
        slots = []
        for w in windows:
            sc = cache_len(w, seq_len, windowed)
            shape = (reps, batch, sc, cfg.n_kv_heads, cfg.head_dim)
            s = torch.empty(shape, dtype=dtype, device="meta")
            slots.append({"k": s, "v": s})
        segs.append(slots)
    return segs


def cache_logical_axes(cfg, plan, batch: int) -> list:
    """Logical sharding axes per cache leaf: batch -> dp when shardable,
    sequence -> sp ('model'); batch==1 long-context shards seq over
    flat."""
    batch_ax = "dp" if batch > 1 else None
    seq_ax = "sp" if batch > 1 else "flat"
    axes = (None, batch_ax, seq_ax, None, None)
    return [[{"k": axes, "v": axes} for _ in windows]
            for _, windows in plan]


def cache_shardings(cfg, plan, batch: int, shard) -> list:
    """``cache_logical_axes`` as ``NamedSharding``s of the policy's mesh."""
    return [[{k: shard.named(*ax) for k, ax in slot.items()}
             for slot in seg] for seg in cache_logical_axes(cfg, plan, batch)]
