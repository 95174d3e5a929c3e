"""One CUDA graph per slot program: the counterpart of ``jax.jit``.

The JAX conductor runs each slot phase as one compiled program, one device
dispatch per slot (srsran_tpu/fapi/conductor.py:448-459).  On the card the
port captures each phase's slot program once as a CUDA graph and replays it
per slot: one graph launch in place of some two hundred kernel launches
from Python.  :class:`SlotGraph` is used by ``SlotConductor.process_slot``
and ``process_slot_batch`` on CUDA; on the CPU they stay eager.

The rules it keeps:

* **Warm before capture.**  Each branch runs once eagerly first: that fills
  every ``device.const`` entry (a miss during capture would upload from
  pageable memory) and every hand kernel's launch plan, and sets the
  kernels' shared-memory attributes.
* **Static inputs.**  The graph owns one copy of each per-call input tensor
  (payload blob, rx samples, PRACH captures, HARQ soft buffers); a call
  copies its inputs into them and then replays.  What a phase owns (its slot
  context, its tables) is bound into the branch functions and keeps its
  address.
* **Outputs copied out.**  A replay overwrites the graph's output tensors,
  while results are resolved a few slots behind the launch front; so each
  call returns fresh copies, made on the caller's stream right after the
  replay.  Graphs may then share one memory pool: their temporaries are dead
  once a replay ends, and every replay runs in the order of one stream.
* **Branches on their own streams.**  Branch 0 is captured on the capturing
  stream, every other branch on a side stream forked from it and joined
  back, so the graph holds them as independent branches (the counterpart of
  XLA overlapping a slot's DL and UL compute).
* **No fallback.**  A capture or replay error raises; nothing runs the
  eager program in a graph's place.
* **Launch counts.**  Capturing records launches without running them, so
  the hand kernels' counts a capture added are taken back, and every replay
  adds them again: a replay launches each captured kernel once more.
"""

from __future__ import annotations

import torch

from . import kernels


def tree_map(fn, tree):
    """fn over the tensors of nested tuples, lists and dicts (other leaves
    pass through)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v) for v in tree)
    return tree


def tensors(tree) -> list:
    """The tensors of a nested structure, in tree_map order."""
    out = []
    tree_map(out.append, tree)
    return out


class SlotGraph:
    """``branches[i](*inputs[i])`` for every i, captured as one CUDA graph.

    branches: callables taking only per-call tensors (nested tuples of
    them); inputs: one tuple of example arguments per branch, on the card,
    with the shapes every later call will have.  ``pool``: a memory pool
    handle (``torch.cuda.graph_pool_handle()``) that graphs of one stream
    may share.  ``nbytes`` is the device memory the capture reserved (the
    static inputs and outputs and the pool's growth).
    """

    def __init__(self, branches, inputs, pool=None):
        self.branches = tuple(branches)
        dev = tensors(inputs)[0].device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()        # as the capture itself does
        reserved = torch.cuda.memory_reserved(dev)
        self.inputs = tree_map(torch.clone, tuple(inputs))
        for fn, args in zip(self.branches, self.inputs):    # warm-up
            fn(*args)
        self.sides = [torch.cuda.Stream(dev) for _ in self.branches[1:]]
        self.graph = torch.cuda.CUDAGraph()
        before = {k.name: k.launches for k in kernels.REGISTRY.values()}
        with torch.cuda.graph(self.graph, pool=pool):
            cur = torch.cuda.current_stream(dev)
            outs = [None] * len(self.branches)
            for i, side in enumerate(self.sides, start=1):
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    outs[i] = self.branches[i](*self.inputs[i])
            outs[0] = self.branches[0](*self.inputs[0])
            for side in self.sides:
                cur.wait_stream(side)
        self.outputs = tuple(outs)
        self.nbytes = torch.cuda.memory_reserved(dev) - reserved
        self.replays = 0
        self.launches = {}          # hand kernel -> launches per replay
        for k in kernels.REGISTRY.values():
            if k.launches != before.get(k.name, 0):
                self.launches[k.name] = k.launches - before.get(k.name, 0)
                k.launches = before.get(k.name, 0)

    def __call__(self, *inputs):
        """Copy ``inputs`` (shaped as the example's) into the static inputs,
        replay, and return a copy of every branch's outputs."""
        src, dst = tensors(inputs), tensors(self.inputs)
        if len(src) != len(dst):
            raise ValueError(f"{len(src)} input tensors for a graph of "
                             f"{len(dst)}")
        for s, d in zip(src, dst):
            if s.shape != d.shape or s.dtype != d.dtype:
                raise ValueError(f"graph input {tuple(s.shape)} {s.dtype} "
                                 f"vs captured {tuple(d.shape)} {d.dtype}")
            d.copy_(s)
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            kernels.REGISTRY[name].launches += n
        return tree_map(torch.clone, self.outputs)
