"""The EPNet modules: layers, PointNet++, LI-Fusion, backbone, RPN,
proposals, target assignment, RCNN and the two-stage detector."""
