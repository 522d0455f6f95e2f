"""EPNet in PyTorch with hand-written CUDA kernels for Hopper (H100).

A port of ``epnet_tpu`` (JAX), which stays beside it as the reference: the
layout mirrors it (``ops/``, ``models/``, ``utils/``, ``csrc/``) and every
module keeps its JAX counterpart's file name. Public functions take the JAX
package's layouts: channels-last ``(B, N, C)`` points and NHWC images.

This package imports torch and numpy only. It never imports jax, flax or
``epnet_tpu``, and reads no file of that package: what it needs of it
(the config tree, the test scenes' box geometry) it keeps as its own copy.

Its entry points (``EPNet``, ``train.trainer.create_train_state``) build
on the CUDA device unless the caller passes another ``device``; without a
card they raise rather than fall back to the CPU.
"""
