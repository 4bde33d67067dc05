"""The GNN family (``repro.models.gnn``'s port): ``so3`` (spherical
harmonics, Wigner rotations, m-truncation), ``graph`` (segment ops,
``LocalEdges``, ``ShardedEdges`` at one shard, ``partition_edges``),
``sampler`` (the numpy fanout sampler) and ``equiformer_v2``
(``EquiformerV2``, its losses and ``repro``'s parameter tree)."""
