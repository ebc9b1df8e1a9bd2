"""EAGS-SLAM on PyTorch + CUDA: the port of `eags_slam_tpu` to one NVIDIA GPU.

Same module layout and public names as the JAX package. The per-frame path
(sorted- or entry-binned-rasterizer tracking + mapping, the edge VO) and
loop closure (`lc/`, on a thread and CUDA stream of its own) run here; every
compositing kernel is hand-written CUDA C++ for Hopper (`csrc/`), each with
a plain PyTorch twin in `ops/` that the CPU takes. `parallel/` runs the
mapping and tracking over a mesh of ranks (`torch.distributed`, one process
a card). `python -m eags_slam_torch.bench` runs bench.py's protocol on the
card, `python -m eags_slam_torch.mesh_bound` the mesh F1 ceiling. Every
module of the JAX package has its counterpart here, the dense `jnp`
compositor, LPIPS, the native frame loader and the CPU-pinned VO among
them.

Nothing in this package imports JAX.
"""
