"""KV caches for decode: per segment x slot, ring-buffered windows (the
port of ``repro.models.kv_cache``).

Layers are organised into segments of ``reps`` repetitions of an attention
pattern (``transformer.segment_plan``). Sliding-window slots allocate only
``min(window, seq)`` positions: a ring buffer, which attention reads in
any order because RoPE is applied to K before it is cached; unlike
``repro``'s, every window slot gets its ring (``repro``'s ``windowed=False``
full-length variant has no caller). ``repro``'s ``cache_specs`` and
``cache_logical_axes`` (dry-run and sharding helpers) wait for the sharded
engine.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import resolve_device


def cache_len(window: int, seq_len: int) -> int:
    return min(window, seq_len) if window else seq_len


def init_cache(cfg, plan, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda") -> list:
    """Returns [segments][slots] of {"k","v"}: zeros [reps, B, Sc, kv, hd]
    of ``dtype`` on ``device``."""
    dev = resolve_device(device)
    segs = []
    for reps, windows in plan:
        slots = []
        for w in windows:
            sc = cache_len(w, seq_len)
            shape = (reps, batch, sc, cfg.n_kv_heads, cfg.head_dim)
            slots.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                          "v": torch.zeros(shape, dtype=dtype, device=dev)})
        segs.append(slots)
    return segs
