"""PyTorch/CUDA port of ``absolutetrack_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's subpackage and module names. It
imports torch and numpy only. Entry points (``UmeTrackModel``,
``load_jax_params``, ``HandTracker``) run on ``cuda`` unless the caller
passes ``device="cpu"``; on a CPU tensor every kernel wrapper takes its
plain PyTorch version.

Public functions keep the JAX package's layouts: crops (B, V, H, W),
features (B, h, w, C), cameras as batched NamedTuples of tensors. The
network's building blocks (the ``nn.Module``s, ``apply_ftl``,
``fuse_views``, ``temporal_step``) run NCHW inside ``UmeTrackModel``.
"""
