"""Work of furthest point sampling at a cell's shapes, as the operation
needs it (the count of ``chip_smoke.py``'s kernel A bound): each of the
``npoint - 1`` steps updates every point's distance to the last pick and
takes the argmax, 10 operations a point at the f32 peak; the cloud read
once and the picks written once."""

from __future__ import annotations

from . import peaks


def call_seconds(clouds: int, n: int, npoint: int) -> float:
    """The least time of one call over ``clouds`` clouds of ``n`` points."""
    ops = 10.0 * clouds * n * (npoint - 1)
    nbytes = 4.0 * clouds * n * 3 + 8.0 * clouds * npoint
    return max(ops / peaks.F32_FLOPS, nbytes / peaks.MEMORY_BYTES)


def calls(cfg: dict, batch: int, mode: str):
    """(clouds, n, npoint) of every FPS call of one eval forward or train
    step at ``batch`` scans: the RPN's stages, then the RCNN tower's over
    its RoIs."""
    rpn, rc = cfg['RPN'], cfg['RCNN']
    n = [rpn['NUM_POINTS']] + list(rpn['SA_CONFIG']['NPOINTS'])
    out = [(batch, n[i], n[i + 1]) for i in range(len(n) - 1)]
    rois = cfg['TEST']['RPN_POST_NMS_TOP_N'] if mode == 'eval' else rc['ROI_PER_IMAGE']
    pts = rc['NUM_POINTS']
    for npoint in rc['SA_CONFIG']['NPOINTS']:
        if npoint == -1:
            break
        out.append((batch * rois, pts, npoint))
        pts = npoint
    return out


def step_seconds(cfg: dict, batch: int, mode: str) -> float:
    """The least time of a step's FPS calls, one after the other."""
    return sum(call_seconds(*c) for c in calls(cfg, batch, mode))
