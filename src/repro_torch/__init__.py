"""Flare: flexible in-network allreduce, ported to PyTorch and CUDA.

The port of the JAX package ``repro``: emulated ranks are the leading
tensor axes of one device (``mesh.RankMesh``), the reduction engine
(``core.engine.GradReducer``) drives the emulated switch data plane
(``switch``), and the switch's fixed-tree fold runs as a hand-written
CUDA kernel (``kernels``).  It imports ``torch`` and numpy, never JAX.
"""
