"""3x3 SAME convolutions of the image tower with a hand-written weight
gradient: the CUDA kernels ``csrc/conv3x3_dw.cu`` (D, stride 2; E, stride
1) and their plain PyTorch versions.

Port of ``epnet_tpu/ops/conv2d.py``. Public functions take NHWC inputs and
HWIO weights, as the JAX package's do. ``conv3x3_same(x, w, stride)`` gives
the values of a SAME convolution (XLA's pads: (0, 1) for stride 2 on even
sizes) and its gradients:

* the forward is ``F.conv2d`` on the padded input;
* dx is PyTorch's convolution backward (cuDNN on the card), as the JAX
  package leaves dx to XLA;
* dw is ``dw3x3_s2`` or ``dw3x3_s1``: the kernel for a CUDA tensor, the
  plain version for a CPU tensor, with no fallback between the two.

``models/layers.Conv2dBlock`` sends every conv that
``conv3x3_same_available`` admits here; there is no other weight-gradient
route for those convs.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build


def conv3x3_same_available(x_shape, features: int, kernel: int, stride: int) -> bool:
    """Whether a bias-free ``kernel`` x ``kernel`` conv of an NHWC input of
    ``x_shape`` to ``features`` channels goes through ``conv3x3_same``: the
    counterpart of the JAX package's ``_dw_available`` (stride 2) and
    ``conv3x3_same_available`` (stride 1), decided by shape alone.

    * 3x3, input and output channels multiples of 4 (the kernels load
      float4s);
    * stride 2: even H and W (kernel D);
    * stride 1: more than 8 input channels, so the RGB stem keeps
      ``nn.Conv2d`` as it keeps its own conv in JAX (kernel E).

    The JAX package's switches ``EPNET_PALLAS_DW`` and ``EPNET_S1_SHIFT_DW``
    chose between two TPU routes by speed; the port has one route for these
    convs and reads neither. Dropped as TPU-only: a row tile that divides
    H/2 and ``C * F <= 256 * 256`` (its 16 MB of VMEM), and the TPU backend
    check. All four stride-2 tower convs take D, blk3's 512 x 512 included.
    ``EPNET_S2_BARRIER`` and ``EPNET_S2_PHASE_BWD`` steer XLA's fusion and
    mean nothing here.
    """
    C = x_shape[-1]
    if kernel != 3 or C % 4 or features % 4:
        return False
    if stride == 2:
        return x_shape[1] % 2 == 0 and x_shape[2] % 2 == 0
    return stride == 1 and C > 8


def same_pads(size: int, kernel: int, stride: int):
    """TensorFlow/XLA 'SAME' padding (before, after) along one axis: for a
    stride-2 3x3 conv on an even size that is (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _nchw_pads(x_nchw: torch.Tensor, kernel: int, stride: int):
    """``F.pad`` widths (left, right, top, bottom) of a SAME conv."""
    top, bottom = same_pads(x_nchw.shape[2], kernel, stride)
    left, right = same_pads(x_nchw.shape[3], kernel, stride)
    return left, right, top, bottom


def _check_shapes(what: str, x: torch.Tensor, dy: torch.Tensor, stride: int):
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError(f'{what}: x and dy must be NHWC, got {tuple(x.shape)} and '
                         f'{tuple(dy.shape)}')
    B, H, W, _ = x.shape
    if stride == 2 and (H % 2 or W % 2):
        raise ValueError(f'{what}: stride 2 needs even H and W, got {H} x {W}')
    if tuple(dy.shape[:3]) != (B, H // stride, W // stride):
        raise ValueError(f'{what}: dy {tuple(dy.shape)} does not match x {tuple(x.shape)} '
                         f'at stride {stride}')


def dw3x3_s2_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the 3x3 SAME stride-2 conv (even H, W), as 9
    strided-phase matmuls (JAX ``_dw_phase_s2``): slot (d, e) is
    ``x[:, d::2, e::2]^T dy``. The bottom and right taps (d or e = 2) of the
    last output row and column read the SAME pad, so their phase falls one
    row or column short and is padded with zeros.

    :param x: (B, H, W, C); dy: (B, H/2, W/2, F)
    :return: (3, 3, C, F)
    """
    _check_shapes('dw3x3_s2_plain', x, dy, 2)
    C, F_ = x.shape[-1], dy.shape[-1]
    H2, W2 = dy.shape[1], dy.shape[2]
    dyf = dy.reshape(-1, F_)
    slots = []
    for d in range(3):
        for e in range(3):
            xs = x[:, d::2, e::2, :]
            xs = F.pad(xs, (0, 0, 0, W2 - xs.shape[2], 0, H2 - xs.shape[1]))
            slots.append(xs.reshape(-1, C).t() @ dyf)
    return torch.stack(slots).reshape(3, 3, C, F_)


def dw3x3_s1_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the 3x3 SAME stride-1 conv, as 9 shifted matmuls
    over the 1-padded input (JAX ``_dw_shift_s1``):
    ``dw[d, e] = sum_{h,w} xpad[h + d, w + e]^T dy[h, w]``.

    :param x: (B, H, W, C); dy: (B, H, W, F)
    :return: (3, 3, C, F)
    """
    _check_shapes('dw3x3_s1_plain', x, dy, 1)
    _, H, W, C = x.shape
    F_ = dy.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    dyf = dy.reshape(-1, F_)
    slots = [xp[:, d:d + H, e:e + W, :].reshape(-1, C).t() @ dyf
             for d in range(3) for e in range(3)]
    return torch.stack(slots).reshape(3, 3, C, F_)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library('conv3x3_dw')
    if not getattr(lib, '_epnet_typed', False):
        lib.epnet_conv3x3_dw_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                                + [ctypes.c_void_p])
        lib.epnet_conv3x3_dw_launch.restype = ctypes.c_int
        lib.epnet_conv3x3_dw_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.epnet_conv3x3_dw_tiles.restype = ctypes.c_longlong
        lib._epnet_typed = True
    return lib


_BLOCKS_PER_SM = 2    # resident blocks of csrc/conv3x3_dw.cu (launch bounds, registers)
_WAVES = 4            # target waves of blocks, so the last one is a small share
_MIN_SPLIT_PIXELS = 256  # a split shorter than this costs more to reduce than it saves


def _dw_kernel(what: str, x: torch.Tensor, dy: torch.Tensor, stride: int) -> torch.Tensor:
    """Launch ``csrc/conv3x3_dw.cu`` (and its fixed-order reduction of the
    per-split slices) on the current stream; returns (3, 3, C, F) f32."""
    for name, t in (('x', x), ('dy', dy)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f'{what}: {name} must be on {x.device} (CUDA), got {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{what}: {name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous NHWC')
        if t.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be 16-byte aligned')
    _check_shapes(what, x, dy, stride)
    B, H, W, C = x.shape
    F_ = dy.shape[-1]
    if C % 4 or F_ % 4:
        raise ValueError(f'{what}: channels must be multiples of 4, got C {C}, F {F_}')
    lib = _lib()
    dev = x.device
    tiles = lib.epnet_conv3x3_dw_tiles(C, F_)
    pixels = B * (H // stride) * (W // stride)
    resident = _BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(_WAVES * resident // tiles, pixels // _MIN_SPLIT_PIXELS))
    part = torch.empty((splits, 9 * C * F_), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, C, F_), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.epnet_conv3x3_dw_launch(x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                                          dw.data_ptr(), B, H, W, C, F_, stride, splits, stream)
    cuda_build.check(lib, err, f'{what} launch')
    return dw


def dw3x3_s2_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel D: the stride-2 weight gradient on the card. x (B, H, W, C)
    and dy (B, H/2, W/2, F) float32, contiguous, on one CUDA device; even
    H and W; C and F multiples of 4. Raises on anything else."""
    dw = _dw_kernel('dw3x3_s2_kernel', x, dy, 2)
    dw3x3_s2_kernel.launches += 1
    return dw


dw3x3_s2_kernel.launches = 0


def dw3x3_s1_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel E: the stride-1 weight gradient on the card. x (B, H, W, C)
    and dy (B, H, W, F) as for ``dw3x3_s2_kernel``."""
    dw = _dw_kernel('dw3x3_s1_kernel', x, dy, 1)
    dw3x3_s1_kernel.launches += 1
    return dw


dw3x3_s1_kernel.launches = 0


def _on_device(kernel, plain, x, dy):
    if x.is_cuda:
        return kernel(x, dy)
    if x.device.type == 'cpu':
        return plain(x, dy)
    raise ValueError(f'unsupported device {x.device}')


def dw3x3_s2(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) stride-2 weight gradient: kernel D for CUDA tensors,
    the plain version for CPU tensors."""
    return _on_device(dw3x3_s2_kernel, dw3x3_s2_plain, x, dy)


def dw3x3_s1(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) stride-1 weight gradient: kernel E for CUDA tensors,
    the plain version for CPU tensors."""
    return _on_device(dw3x3_s1_kernel, dw3x3_s1_plain, x, dy)


class _Conv3x3Same(torch.autograd.Function):
    """Saves the NHWC input (for dw), and the padded NCHW input and the
    OIHW weight (for dx, the same convolution backward that autograd runs
    for ``nn.Conv2d``)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        x_nchw = x.permute(0, 3, 1, 2)
        pads = _nchw_pads(x_nchw, 3, stride)
        xp = F.pad(x_nchw, pads)
        w_oihw = w.permute(3, 2, 0, 1)
        ctx.save_for_backward(x, xp, w_oihw)
        ctx.stride, ctx.pads = stride, pads
        return F.conv2d(xp, w_oihw, None, (stride, stride)).permute(0, 2, 3, 1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, xp, w_oihw = ctx.saved_tensors
        s = ctx.stride
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp = torch.ops.aten.convolution_backward(
                dy.permute(0, 3, 1, 2), xp, w_oihw, None, (s, s), (0, 0), (1, 1), False,
                (0, 0), 1, (True, False, False))[0]
            left, right, top, bottom = ctx.pads  # the pad's own backward: a negative pad
            dx = F.pad(dxp, (-left, -right, -top, -bottom)).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = (dw3x3_s2 if s == 2 else dw3x3_s1)(x.contiguous(), dy.contiguous())
        return dx, dw, None


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B, H, W, C), w (3, 3, C, F) -> (B, H', W', F): a SAME 3x3 conv
    with stride 1 or 2, differentiable in both. The weight gradient is
    kernel D or E on the card, the plain version on the CPU."""
    if stride not in (1, 2) or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f'conv3x3_same: x {tuple(x.shape)}, w {tuple(w.shape)}, '
                         f'stride {stride}')
    return _Conv3x3Same.apply(x, w, stride)
