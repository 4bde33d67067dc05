"""Logical-axis sharding policy, the mapping half (the port of
``repro.distributed.sharding``): model code names logical axes, the
policy maps them to mesh axes. ``mesh=None`` maps every axis to size 1,
so the same code runs on one device.

Logical axes:
  dp     data parallel (batch)                  -> ('pod', 'data') / ('data',)
  tp     tensor parallel (heads/ffn/vocab/experts/channels/corpus)
  sp     sequence parallel (long-context KV / activations)
  flat   everything (node/edge/candidate sharding over all devices)

``spec`` returns the per-dimension tuple a ``jax.sharding.PartitionSpec``
holds (None, one mesh axis name, or a tuple of two or more). The
placement half (``named``, ``constrain``, ``tree_shardings``) belongs to
the model sharding and is not ported: the retrieval mesh path places its
slabs itself (``retrieval.store.split_slabs``).
"""
from __future__ import annotations

DEFAULT_RULES = {
    "dp": ("data",),
    "tp": ("model",),
    "sp": ("model",),
    "flat": ("data", "model"),
}


def rules_for_mesh(mesh) -> dict:
    rules = {k: tuple(v) for k, v in DEFAULT_RULES.items()}
    if mesh is not None and "pod" in mesh.axis_names:
        rules["dp"] = ("pod", "data")
        rules["flat"] = ("pod", "data", "model")
    return rules


class ShardingPolicy:
    def __init__(self, mesh, rules: dict | None = None,
                 overrides: dict | None = None):
        self.mesh = mesh
        self.rules = dict(rules or rules_for_mesh(mesh))
        if overrides:
            self.rules.update(overrides)

    def _resolve(self, axis):
        if axis is None:
            return None
        if isinstance(axis, (tuple, list)):
            out: list = []
            for a in axis:
                r = self._resolve(a)
                if r is None:
                    continue
                out.extend(r if isinstance(r, tuple) else (r,))
            return tuple(out) if out else None
        got = self.rules.get(axis, axis)
        if isinstance(got, (tuple, list)):
            got = tuple(got)
            return got if len(got) != 1 else got[0]
        return got

    def spec(self, *axes) -> tuple:
        return tuple(_canonical(self._resolve(a)) for a in axes)

    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        r = self._resolve(logical)
        if r is None:
            return 1
        if isinstance(r, str):
            r = (r,)
        n = 1
        for a in r:
            n *= self.mesh.shape[a]
        return n


def _canonical(entry):
    """One dimension's entry as ``PartitionSpec`` stores it: a 1-tuple of
    axis names as its name, an empty tuple as None."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


def divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0
