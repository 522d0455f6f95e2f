"""Point, box and image operators; the hand-written kernels live behind
``fps.py``, ``sa_fused.py``, ``conv2d.py`` and ``nms.py`` (sources in
``../csrc``)."""
