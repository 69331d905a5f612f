"""PyTorch + CUDA port of ``pointcloudsegmentation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here mirrors
one of its modules, keeps its names and shapes at the public functions, and
is held against it by the ``tests/test_torch_*.py`` parity tests.

Rules the port keeps:

- it imports ``torch`` and never JAX; from the JAX package it imports only
  the numpy-only host code (``pointcloudsegmentation_tpu.data.toy``,
  ``data.batching``, ``data.native``);
- devices are explicit, randomness comes from explicit ``torch.Generator``s,
  and the compute dtype is a constructor argument;
- it reads no environment variables: the JAX package's ``PCS_*`` knobs are
  fixed at their default values;
- the windowed gather runs as a hand-written CUDA kernel on CUDA tensors
  (``kernels/window_gather.py``) and as its plain PyTorch version on CPU
  tensors.

Ported so far: the flagship ``pointnet_s3dis`` inference path (block sweep,
softmax, dense interpolation).  See ROADMAP.md for what is still to port.
"""

__version__ = "0.1.0"
