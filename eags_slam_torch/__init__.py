"""EAGS-SLAM on PyTorch + CUDA: the port of `eags_slam_tpu` to one NVIDIA GPU.

Same module layout and public names as the JAX package. The per-frame main
path (sorted-rasterizer tracking + mapping, const-speed odometry, loop
closure off) runs here; the two compositing kernels of that path are
hand-written CUDA C++ for Hopper (`csrc/`), each with a plain PyTorch twin in
`ops/composite_sorted.py` that the CPU takes.

Nothing in this package imports JAX.
"""
