"""Joint evaluation: detection (``detect.py``), KITTI-format output and the
official KITTI AP (numpy copies of the JAX package's evaluator)."""
