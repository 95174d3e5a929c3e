"""srsran_tpu_torch — the PyTorch/CUDA port of srsran_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (``ops/``, ``phy/upper/``,
``phy/slot_programs.py``) so every port module pairs with the module it
ports.  Plain tensor code is PyTorch; the hot device functions of the slot
are hand-written CUDA kernels (``csrc/``) built at first use by
``kernels/_build.py``.  Each kernel wrapper keeps a plain PyTorch twin: the
twin runs for CPU tensors, the kernel for CUDA tensors, and nothing falls
back from one to the other.

The package imports neither JAX nor anything of the JAX package: it keeps
its own copies of the host-side parameter modules it needs (``ran/``,
``ops/gf2.py``, ``ops/ldpc_graph.py``, ``ops/low_papr.py``) and of their
tables (``data/``), pinned to the originals by the tests.
"""

__version__ = "0.1.0"
