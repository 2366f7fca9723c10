"""dcf_torch: the ContFuse detector (Deep Continuous Fusion for
multi-sensor 3D object detection) in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `dcf`, which stays the reference. Layout
mirrors it: `config`, `data/`, `geometry/`, `models/`, `ops/`, `eval/`.
The kernels' sources are in `csrc/`; `ops/_cuda.py` builds them with
nvcc at first use. Every kernel wrapper runs its plain PyTorch version
for CPU tensors and its kernel for CUDA tensors.

Serving entry point: `dcf_torch.eval.inference.make_inference_fn`.
"""
