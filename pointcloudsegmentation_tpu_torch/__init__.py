"""PyTorch + CUDA port of ``pointcloudsegmentation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here mirrors
one of its modules, keeps its names and shapes at the public functions, and
is held against it by the ``tests/test_torch_*.py`` parity tests.

Rules the port keeps:

- it imports ``torch`` and never JAX, and nothing of the JAX package, not
  even its numpy-only modules: the host code it needs is its own copy
  (``data/``, ``utils/logging.py``; ``data/native.py`` builds the
  repository's ``csrc/pointutil.cpp`` into ``_build/``);
- entry points run on the card (``device="cuda"``) unless the caller asks
  for the CPU; randomness comes from explicit ``torch.Generator``s, and the
  compute dtype is a constructor argument;
- it reads no environment variables: the JAX package's ``PCS_*`` knobs are
  fixed at their default values;
- every TPU kernel runs as a hand-written CUDA kernel on CUDA tensors
  (``kernels/window_gather.py``, ``kernels/fused_conv.py``) and as its
  plain PyTorch version on CPU tensors.

Ported so far: ``pointnet_s3dis`` (the flagship) and ``pointnet_scannet``
with their inference path (block sweep, softmax, dense interpolation) and
training step (``train/loop.py``), the data pipeline, and the user entry
points: ``python -m pointcloudsegmentation_tpu_torch.prepare_data``
prepares datasets offline, ``... .train.cli`` trains and evaluates,
``... .interpolate`` labels prepared scenes (Semantic3D scans down to
their ``.labels`` submission), ``... .parity_ab``
records a training curve on synthetic rooms, ``... .profile_train``
profiles the training step on the card; plus the fused window-conv kernel
with its microbench (``... .bench_fused_conv --level 0``); data and scene
parallelism over ``torch.distributed`` (``parallel/``: the CLI's mesh,
``scene_shard.scene_apply``), with ``... .dryrun`` and ``... .halo_study``.
See ROADMAP.md for what is still to port.
"""

__version__ = "0.1.0"
