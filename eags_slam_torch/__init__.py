"""EAGS-SLAM on PyTorch + CUDA: the port of `eags_slam_tpu` to one NVIDIA GPU.

Same module layout and public names as the JAX package. The per-frame path
(sorted- or entry-binned-rasterizer tracking + mapping, the edge VO) and
loop closure (`lc/`, on a thread and CUDA stream of its own) run here; every
compositing kernel is hand-written CUDA C++ for Hopper (`csrc/`), each with
a plain PyTorch twin in `ops/` that the CPU takes. `parallel/` runs the
mapping and tracking over a mesh of ranks (`torch.distributed`, one process
a card). `python -m eags_slam_torch.bench` runs bench.py's protocol on the
card.

Nothing in this package imports JAX.
"""
