"""Work of the image tower's 3x3 weight gradients in a train step, as the
operation needs it: the direct products, 2 x 9 x C x F for every output
(dy) pixel of each conv whose input has more than 8 channels (the stem's
gradient is another path), at the TF32 dense peak; x and dy read once and
dw written once."""

from __future__ import annotations

from . import peaks

IMG_HW = (384, 1280)


def convs(cfg: dict, batch: int, img_hw=IMG_HW):
    """(C, F, dy pixels, input pixels) of each tower conv with such a
    gradient, at ``batch`` scans."""
    ch = cfg['LI_FUSION']['IMG_CHANNELS']
    H, W = img_hw
    out = []
    for i in range(len(ch) - 1):
        c_in, c = ch[i], ch[i + 1]
        if c_in > 8:
            out.append((c_in, c, batch * H * W, batch * H * W))
        h2, w2 = -(-H // 2), -(-W // 2)
        out.append((c, c, batch * h2 * w2, batch * H * W))
        H, W = h2, w2
    return out


def step_seconds(cfg: dict, batch: int) -> float:
    """The least time of a step's tower weight gradients, one after the
    other."""
    total = 0.0
    for c, f, dy_px, x_px in convs(cfg, batch):
        ops = 2.0 * 9 * c * f * dy_px
        nbytes = 4.0 * (x_px * c + dy_px * f + 9 * c * f)
        total += max(ops / peaks.TF32_FLOPS, nbytes / peaks.MEMORY_BYTES)
    return total
