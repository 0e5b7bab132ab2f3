"""OGC in PyTorch and CUDA: the port of ``ogc_tpu`` to an NVIDIA H100.

Layout mirrors ``ogc_tpu``:
  ops/      point-cloud primitives; FPS, exact and block-min KNN and ball
            query, and the grouping gathers/scatters as hand-written CUDA
            kernels (csrc/) with plain PyTorch versions beside them
  nn/       SharedMLP, PointNet++ SA/FP modules, MaskFormer head, the
            FlowStep3D modules
  models/   MaskFormer3D and FlowStep3D with their per-dataset ARCHS
  losses/   the unsupervised OGC loss, the unsupervised flow loss, the
            supervised mask loss
  train/    the segmentation, flow and supervised trainers
  refine/   OA-ICP and multi-frame voting
  data/, metrics/, utils/   copies of the JAX package's numpy-only
            readers, metrics and helpers, weight conversion, config
            loading, checkpoints
  tools/    synthetic SAPIEN scenes and the protocol runner
  train_seg.py, test_seg.py, oa_icp.py, vote.py, test_flow.py,
  train_flow.py, train_seg_sup.py   the entry points

The package imports nothing of ``ogc_tpu``, jax or flax.  Importing it
imports nothing heavy.
"""
