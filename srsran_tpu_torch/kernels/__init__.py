"""Registry of the hand-written kernels and their launch counts.

Each kernel wrapper registers one :class:`Kernel` and calls
:meth:`Kernel.count` where it launches its CUDA kernel (and nowhere else),
so a run can show that the main path went through the kernel and not
through its plain PyTorch twin.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Kernel:
    name: str
    route: str            # "cuda" or "triton"
    source: str           # path of the kernel source in the repository
    replaces: str         # file:line of the JAX device function it replaces
    launches: int = 0

    def count(self) -> None:
        self.launches += 1


REGISTRY: dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    if kernel.name in REGISTRY:
        raise ValueError(f"kernel {kernel.name!r} registered twice")
    REGISTRY[kernel.name] = kernel
    return kernel


def batched(kernel: Kernel) -> Kernel:
    """Register the slot-batch form of ``kernel``: the same source with a
    slot axis, counted apart (``<name>_batch``) so that a run shows one
    launch per batch of slots, not one per slot."""
    return register(dataclasses.replace(kernel, name=f"{kernel.name}_batch",
                                        launches=0))


def reset_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0
