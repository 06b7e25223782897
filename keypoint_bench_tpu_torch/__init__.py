"""PyTorch / CUDA port of keypoint_bench_tpu for NVIDIA Hopper (H100).

The JAX package `keypoint_bench_tpu` is the unchanged reference; this
package mirrors its module names so each function has an obvious
counterpart. It imports torch and numpy only, never jax and nothing of
the JAX package. Entry points run on CUDA unless `device="cpu"` is passed
(device.py); the hand-written kernels live in `csrc/` and are built with
nvcc at first use (ops/_build.py).
"""
