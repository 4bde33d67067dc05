"""Counting one position's step as it runs (the port of
``repro.launch.hlo_analysis``).

``repro`` walks the partitioned HLO of a compiled cell: the per-device
program, its dot FLOPs with loop trip counts, the result bytes of its
instructions and of its collectives. The port has no compiled program;
it runs its step eagerly, so ``OpCounter`` counts the step as it runs,
op by op, below autograd (a ``TorchDispatchMode``), on ``meta`` tensors
(``launch.dryrun``: a meta mesh runs the body once, as position 0) or on
real ones:

- **Matmul FLOPs** by ``repro``'s dot rule, 2 x prod(result dims) x
  prod(contracting dims) (``hlo_analysis._dot_flops``): ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``convolution`` and every other op that
  ``torch.utils.flop_counter`` knows (the attention kernels). Einsums and
  ``@`` reach the counter as these ops; a loop runs its body as often as
  it runs, so trip counts need no walk. Hand-written kernels add the
  FLOPs of their ``cost`` function (``kernels.dispatch.costing``).
- **Bytes written**: the result bytes of every op that is not a view
  (in-place ops included). The port runs eager with nothing fused, so
  this is the port's own count, not ``repro``'s fusion-level
  ``bytes_written``.
- **Peak live bytes**: the arguments a position holds, plus every
  storage an op makes (activations, tensors saved for the backward,
  gradients) from when it is made until its last reference dies.
- **Collectives**: result bytes and counts by ``repro``'s kinds
  ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"), as
  ``shard_map`` and ``retrieval.topk`` tell them (``sharding.OBSERVERS``:
  position 0's result, forward and backward). They sit beside
  ``shard_map.TRAFFIC``, which counts the bytes that move between
  positions and stays as it is.
- **Kernels**: each hand-written kernel's calls, FLOPs and bytes.

Arguments are registered by storage (``add_arguments``) with their bytes
at one position: a placed argument's slab, or, where a mesh splits a
whole argument, the block position 0 takes (the split is told to the
counter). ``held_bytes`` sums them all, ``argument_bytes`` only those
the step reads (an op that is not a view takes them, or a block
resharded from them): XLA leaves an argument the program never reads out
of ``argument_size_in_bytes``, and so does this count.

On a mesh of real devices the positions run in threads; each thread
counts under its own mode, tagged with its position, and only position
0's ops (and the caller's) are counted. The backward runs on the
caller's thread: an op there belongs to the position whose tensors it
reads (a storage belongs to the position whose op made it; a
collective's results are handed to their positions), and an op that
reads several positions' tensors (a collective's own arithmetic) to
none.
"""
from __future__ import annotations

import weakref
from contextlib import ExitStack

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding as SH
from repro_torch.kernels import dispatch as DSP

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_MIXED = -1                  # owner of a storage made from several positions


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # no storage to count
        return None


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def position_tensors(tree) -> list:
    """The tensors position 0 holds of a tree of arguments: a placed
    tensor's first slab, a model's parameters, every other tensor whole."""
    if isinstance(tree, SH.Sharded):
        return [tree.slabs[0]]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in position_tensors(v)]
    return []


class _Mode(TorchDispatchMode):
    """The counter's dispatch mode on one thread: ``position`` None on the
    caller's thread, else the mesh position whose body the thread runs."""

    def __init__(self, counter, position):
        super().__init__()
        self.counter, self.position = counter, position

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter._op(func, args, kwargs, out, self.position)
        return out


class OpCounter:
    """Counts a step run inside ``with OpCounter() as c:`` (module
    docstring). Register the arguments first (``add_arguments``)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes_written = 0.0
        self.ops = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVE_OPS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.kernels = {}
        self.peak_extra = 0
        self._live_bytes = 0
        self._live = {}           # storage id -> bytes, counted and alive
        self._owner = {}          # storage id -> position (None: caller)
        self._args = {}           # storage id -> [bytes, block, read, storage]
        self._blocks = {}         # storage id -> position 0's block bytes
        self._derived = {}        # storage id -> (argument id, kind, bytes)
        self._resharding = 0      # inside a real mesh's reshard gather
        self._stack = None

    # ---- set-up ---------------------------------------------------------

    def add_arguments(self, tensors) -> None:
        """Register argument tensors (position 0's): each storage once,
        with its bytes."""
        for t in tensors:
            st = _storage(t)
            if st is None:
                continue
            a = self._args.get(id(st))
            b = _nbytes(t)
            if a is None:
                self._args[id(st)] = [b, None, False, st]
            else:
                a[0] = max(a[0], b)

    def __enter__(self):
        self._stack = ExitStack()
        SH.OBSERVERS.append(self._observe)
        self._stack.callback(SH.OBSERVERS.remove, self._observe)
        self._stack.enter_context(DSP.costing(self._cost))
        self._stack.enter_context(_Mode(self, None))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self._stack = None
        return False

    # ---- events ---------------------------------------------------------

    def _cost(self, name: str, flops: float, nbytes: float,
              inputs: tuple) -> None:
        self._reads(inputs)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops

    def _observe(self, event: str, *args) -> None:
        if event == "collective":
            kind, t = args
            self.coll_bytes[kind] += _nbytes(t)
            self.coll_counts[kind] += 1
        elif event == "split":
            whole, blk = args
            st = _storage(whole)
            if st is None:
                return
            b = _nbytes(blk)
            a = self._args.get(id(st))
            if a is not None:
                a[1] = b if a[1] is None else min(a[1], b)
            else:
                self._blocks.setdefault(id(st), b)
        elif event == "derived":
            src, out, kind = args
            s_src, s_out = _storage(src), _storage(out)
            if s_src is not None and id(s_src) in self._args:
                self._derived[id(s_out)] = (id(s_src), kind, _nbytes(out))
                weakref.finalize(s_out, self._derived.pop, id(s_out), None)
        elif event == "reshard":
            self._resharding += 1 if args[0] else -1
        elif event == "owners":
            for i, t in enumerate(args[0]):
                st = _storage(t) if isinstance(t, torch.Tensor) else None
                if st is not None and id(st) in self._owner:
                    self._set_owner(id(st), i, st.nbytes())
        elif event == "position":
            stack, index = args
            stack.enter_context(_Mode(self, index))

    # ---- ops --------------------------------------------------------------

    def _free(self, sid: int) -> None:
        self._owner.pop(sid, None)
        b = self._live.pop(sid, None)
        if b is not None:
            self._live_bytes -= b

    def _set_owner(self, sid: int, owner, nbytes: int) -> None:
        self._owner[sid] = owner
        if owner in (None, 0):
            if sid not in self._live:
                self._live[sid] = nbytes
                self._live_bytes += nbytes
                self.peak_extra = max(self.peak_extra, self._live_bytes)
        elif sid in self._live:
            self._live_bytes -= self._live.pop(sid)

    def _op(self, func, args, kwargs, out, position) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if position is None:
            # the caller's thread (the backward too): the op belongs to
            # the position whose tensors it reads
            owners = set()
            for t in ins:
                st = _storage(t)
                if st is not None:
                    o = self._owner.get(id(st))
                    if o is not None:
                        owners.add(o)
            owner = (None if not owners else
                     owners.pop() if len(owners) == 1 else _MIXED)
        else:
            owner = position
        for t in outs:
            st = _storage(t)
            if st is None:
                continue
            sid = id(st)
            if sid in self._args or sid in self._owner:
                continue
            self._set_owner(sid, owner, st.nbytes())
            weakref.finalize(st, self._free, sid)
        if not func.is_view:
            self._reads(ins)
        if owner not in (None, 0):
            return
        self.ops += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes_written += sum(_nbytes(t) for t in outs)

    def _reads(self, ins) -> None:
        """Mark the registered arguments among an op's inputs read (by
        whichever position: the registered storages are position 0's or
        shared), and count a resharded block's collective where it is
        first read; a reshard's own gather reads nothing yet."""
        for t in ins:
            st = _storage(t)
            if st is None:
                continue
            a = self._args.get(id(st))
            if a is not None:
                a[2] = a[2] or not self._resharding
                continue
            d = self._derived.pop(id(st), None)
            if d is not None:
                src, kind, b = d
                self._args[src][2] = True
                if kind is not None:
                    self.coll_bytes[kind] += b
                    self.coll_counts[kind] += 1

    # ---- results ----------------------------------------------------------

    def _arg_bytes(self, read_only: bool) -> int:
        return sum(a[0] if a[1] is None else a[1]
                   for a in self._args.values() if a[2] or not read_only)

    @property
    def held_bytes(self) -> int:
        """Bytes of every argument a position holds."""
        return self._arg_bytes(False)

    @property
    def argument_bytes(self) -> int:
        """Bytes of the arguments the step read, at one position."""
        return self._arg_bytes(True)

    @property
    def peak_bytes(self) -> int:
        """The held arguments plus the most the step's own storages took
        at once."""
        return self.held_bytes + self.peak_extra

    def block_bytes(self, t: torch.Tensor) -> int:
        """Position 0's bytes of ``t``: its block where a mesh split or
        assembled it, else all of it."""
        st = _storage(t)
        return self._blocks.get(id(st), _nbytes(t)) if st is not None \
            else _nbytes(t)

    def struct(self) -> dict:
        """``repro``'s ``analyse_module`` keys: FLOPs, bytes written and
        collective result bytes (the kinds that occurred) at one
        position."""
        coll = {k: float(v) for k, v in self.coll_bytes.items() if v}
        return {"flops": float(self.flops),
                "bytes_written": float(self.bytes_written),
                "collective_bytes": coll,
                "collective_total": float(sum(coll.values()))}

    def collectives(self) -> dict:
        """``repro``'s ``collective_bytes`` keys: bytes and counts of every
        kind, and their total."""
        return {"bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values())}
