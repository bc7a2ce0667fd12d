"""point_slam_tpu_torch — the PyTorch/CUDA port of point_slam_tpu.

The same dense neural point-cloud RGB-D SLAM (joint camera tracking and
neural-point mapping with depth-guided volumetric rendering), written for
one NVIDIA H100: plain tensor code is PyTorch, and the ray-shared top-8
neighbour selection that the JAX package runs as a Pallas kernel is a CUDA
C++ kernel (``ops/csrc/ray_topk.cu``) built for ``sm_90a`` at first use.

The module layout and function names follow ``point_slam_tpu`` one to one so
each function's reference is easy to find. This package imports neither
``jax`` nor ``point_slam_tpu``.

Float32 matrix products and convolutions run in full float32 (TF32 off):
the decoders' Fourier phases reach ~1e3 rad and the reference runs them in
full float32 too.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
