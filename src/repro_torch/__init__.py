"""PyTorch/CUDA port of the FedHC simulator.

The JAX package ``repro`` is the reference this package is held against;
nothing here imports it.  Module paths mirror it
(``repro_torch/core/engine.py`` <-> ``repro/core/engine.py``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; the two
hot-path kernels (``weighted_agg_multi``, ``kmeans_assign``) are CUDA C++
for ``sm_90a`` under ``csrc/``, built at first use (`kernels/build.py`).
"""
