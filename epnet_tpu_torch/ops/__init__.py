"""Point, box and image operators; the hand-written kernels live behind
``fps.py`` and ``sa_fused.py`` (sources in ``../csrc``)."""
