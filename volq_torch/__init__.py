"""volq_torch: the PyTorch + CUDA port of volq (the JAX package stays the
reference).  Pure PyTorch around two hand-written Hopper kernels
(``csrc/warp_march.cu``, ``csrc/warp_composite.cu``); imports no JAX and
nothing of ``volq``.

Layout mirrors ``volq/``: ``scene/`` (config, init), ``core/`` (types,
camera), ``volume/`` (noise, bake), ``sim/`` (threefry PRNG, emission,
forces, step), ``render/`` (warp engine + kernel wrappers),
``engine/`` (frame loop), ``convert.py`` (numpy <-> port state).
"""
