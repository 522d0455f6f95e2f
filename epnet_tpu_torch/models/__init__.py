"""The EPNet modules: layers, PointNet++, LI-Fusion, backbone, RPN,
proposals, RCNN and the two-stage detector (eval forward)."""
