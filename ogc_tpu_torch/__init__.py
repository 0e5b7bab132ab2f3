"""OGC in PyTorch and CUDA: the port of ``ogc_tpu`` to an NVIDIA H100.

Layout mirrors ``ogc_tpu``:
  ops/      point-cloud primitives; FPS and exact KNN as hand-written CUDA
            kernels (csrc/) with plain PyTorch versions beside them
  nn/       SharedMLP, PointNet++ SA/FP modules, MaskFormer head
  models/   MaskFormer3D segnet with the per-dataset ARCHS table
  utils/    weight conversion from the JAX package (numpy only), config
            loading, checkpoints
  test_seg.py  the segmentation evaluation entry point

The data readers, metrics, meters and native helpers are reused from
``ogc_tpu`` (they import neither jax nor flax).  Importing this package
imports nothing heavy.
"""
