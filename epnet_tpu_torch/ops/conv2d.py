"""3x3 SAME convolutions of the image tower with hand-written kernels: the
stride-2 forward (kernel F, ``csrc/conv3x3_s2_fwd.cu``) and the weight
gradients (``csrc/conv3x3_dw.cu``: D, stride 2; E, stride 1), each beside
its plain PyTorch version.

Port of ``epnet_tpu/ops/conv2d.py`` and of the stride-2 forward of
``tools/conv_fwd_attic.py``. Public functions take NHWC inputs and HWIO
weights, as the JAX package's do. ``conv3x3_same(x, w, stride)`` gives the
values of a SAME convolution (XLA's pads: (0, 1) for stride 2 on even
sizes) and its gradients:

* the forward is ``conv3x3_s2_fwd`` at stride 2 and ``F.conv2d`` on the
  padded input at stride 1 (the JAX package has no Pallas stride-1
  forward);
* dx is PyTorch's convolution backward (cuDNN on the card), as the JAX
  package leaves dx to XLA;
* dw is ``dw3x3_s2`` or ``dw3x3_s1``.

Each of ``conv3x3_s2_fwd``, ``dw3x3_s2`` and ``dw3x3_s1`` runs its kernel
for a CUDA tensor and its plain version for a CPU tensor, with no fallback
between the two. In f32 all three kernels multiply on the TF32 tensor cores
in three passes (each operand split into TF32 hi and lo pieces, rounded to
nearest; lo*hi + hi*lo + hi*hi summed in f32), which keeps f32's accuracy;
D and E are one kernel at two strides.

In bf16 (the ``MIXED_PRECISION`` tower, ``epnet_tpu/models/layers.py:
192-199``) the forward takes bf16 x and w and returns bf16: at stride 2
kernel F-bf16 (bf16 products on the tensor cores, f32 accumulation in F's
tap-then-channel order, one rounding at the end, as the Pallas kernel's
bf16 dot and ``x.dtype`` output, ``conv_fwd_attic.py:73-76, 167``), at
stride 1 ``F.conv2d`` in bf16, as the JAX package leaves it to
XLA's conv (``epnet_tpu/ops/conv2d.py:51,112``). The backward's dx is
PyTorch's convolution backward in bf16, and dw the weight-gradient
kernel's bf16 instance (D-bf16, E-bf16: bf16 products on the tensor cores
summed in f32), its f32 sum rounded to w's dtype once, as the Pallas
kernel's f32 output is cast (``conv2d.py:191``) and as XLA's bf16 weight
gradient rounds it on the JAX package's default route (``:209-212``).

``models/layers.Conv2dBlock`` sends every conv that
``conv3x3_same_available`` admits here; there is no other route for those
convs.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build


def conv3x3_same_available(x_shape, features: int, kernel: int, stride: int) -> bool:
    """Whether a bias-free ``kernel`` x ``kernel`` conv of an NHWC input of
    ``x_shape`` to ``features`` channels goes through ``conv3x3_same``: the
    counterpart of the JAX package's ``_dw_available`` (stride 2) and
    ``conv3x3_same_available`` (stride 1), decided by shape alone.

    * 3x3, input and output channels multiples of 4: the kernels copy 4
      values (16 bytes in f32) at a time, and F-bf16 copies 8 bf16 values
      (16 bytes) when both are multiples of 8 and 4 (8 bytes) otherwise;
    * stride 2: even H and W (kernels F and D);
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
    row or column short and is padded with zeros. bf16 x and dy (D-bf16's
    function) are multiplied and summed in f32 (their products are exact
    there).

    :param x: (B, H, W, C); dy: (B, H/2, W/2, F)
    :return: (3, 3, C, F) float32
    """
    _check_shapes('dw3x3_s2_plain', x, dy, 2)
    x, dy = x.float(), dy.float()
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


def _check_fwd(what: str, x: torch.Tensor, w: torch.Tensor):
    if x.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]) or w.dim() != 4:
        raise ValueError(f'{what}: x must be NHWC and w (3, 3, C, F), got {tuple(x.shape)} '
                         f'and {tuple(w.shape)}')
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f'{what}: stride 2 needs even H and W, got {x.shape[1]} x {x.shape[2]}')


def conv3x3_s2_fwd_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 3x3 SAME stride-2 conv (even H, W) as 9 strided-phase matmuls
    summed in tap order, the plain version of kernel F: tap (d, e) adds
    ``x[:, d::2, e::2] @ w[d, e]``. The bottom and right taps (d or e = 2)
    of the last output row and column read the SAME pad, so their phase
    falls one row or column short and is padded with zeros. bf16 x and w
    (F-bf16's function) are multiplied and summed in f32 and the sum is
    rounded to bf16 once.

    :param x: (B, H, W, C); w: (3, 3, C, F)
    :return: (B, H/2, W/2, F) in x's dtype
    """
    _check_fwd('conv3x3_s2_fwd_plain', x, w)
    if x.dtype == torch.bfloat16:
        return conv3x3_s2_fwd_plain(x.float(), w.float()).to(torch.bfloat16)
    B, H, W, C = x.shape
    H2, W2 = H // 2, W // 2
    y = None
    for d in range(3):
        for e in range(3):
            xs = x[:, d::2, e::2, :]
            xs = F.pad(xs, (0, 0, 0, W2 - xs.shape[2], 0, H2 - xs.shape[1]))
            term = xs.reshape(-1, C) @ w[d, e]
            y = term if y is None else y + term
    return y.reshape(B, H2, W2, w.shape[-1])


def dw3x3_s1_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the 3x3 SAME stride-1 conv, as 9 shifted matmuls
    over the 1-padded input (JAX ``_dw_shift_s1``):
    ``dw[d, e] = sum_{h,w} xpad[h + d, w + e]^T dy[h, w]``; bf16 x and dy
    (E-bf16's function) as in ``dw3x3_s2_plain``.

    :param x: (B, H, W, C); dy: (B, H, W, F)
    :return: (3, 3, C, F) float32
    """
    _check_shapes('dw3x3_s1_plain', x, dy, 1)
    x, dy = x.float(), dy.float()
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
        for fn in (lib.epnet_conv3x3_dw_launch, lib.epnet_conv3x3_dw_bf16_launch):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.epnet_conv3x3_dw_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.epnet_conv3x3_dw_tiles.restype = ctypes.c_longlong
        lib._epnet_typed = True
    return lib


def _fwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library('conv3x3_s2_fwd')
    if not getattr(lib, '_epnet_typed', False):
        # F takes one more scratch pointer than F-bf16: wt, K's split planes
        for fn, pointers in ((lib.epnet_conv3x3_s2_fwd_launch, 5),
                             (lib.epnet_conv3x3_s2_fwd_bf16_launch, 4)):
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.epnet_conv3x3_s2_fwd_tiles.argtypes = [ctypes.c_int] * 4
        lib.epnet_conv3x3_s2_fwd_tiles.restype = ctypes.c_longlong
        lib.epnet_conv3x3_s2_fwd_bf16_blocks.argtypes = []
        lib.epnet_conv3x3_s2_fwd_bf16_blocks.restype = ctypes.c_int
        for fn in (lib.epnet_conv3x3_s2_fwd_steps, lib.epnet_conv3x3_s2_fwd_bf16_steps):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_int
        lib._epnet_typed = True
    return lib


_BLOCKS_PER_SM = 2    # resident blocks of F, D and E (launch bounds); F-bf16 reports its own
_DW_WAVES = 3         # D, E: target waves of blocks, so the last one is a small share
_MIN_SPLIT_PIXELS = 256  # dw: a split shorter than this costs more to reduce than it saves
_FWD_WAVES = 1        # F: waves to fill before K is split (each split adds an M x F slice)
_MIN_SPLIT_STEPS = 16  # F: steps of K (tap, 16 channels) a split keeps at least
_BF16_WAVES = 1       # F-bf16: as _FWD_WAVES (its tensor-core tiles end sooner than F's)
_BF16_MIN_SPLIT_STEPS = 4  # F-bf16: as _MIN_SPLIT_STEPS, steps of (tap, 64 channels)


def _check_cuda(what: str, dtype=torch.float32, **tensors):
    """Every tensor CUDA ``dtype``, contiguous, aligned to four elements (16
    bytes in f32, 8 in bf16), on one device. F-bf16 copies 16 bytes where x
    and w are 16-byte aligned (and C and F multiples of 8), else 8; the
    kernel decides that itself, so 8-byte alignment is all it needs."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f'{what}: {name} must be on {dev} (CUDA), got {t.device}')
        if t.dtype != dtype:
            raise TypeError(f'{what}: {name} must be {dtype}, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous')
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f'{what}: {name} must be {4 * t.element_size()}-byte aligned')


def _resident_blocks(dev) -> int:
    return _BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count


def _dw_kernel(what: str, x: torch.Tensor, dy: torch.Tensor, stride: int,
               dtype=torch.float32) -> torch.Tensor:
    """Launch ``csrc/conv3x3_dw.cu`` (and its fixed-order reduction of the
    per-split slices) on the current stream, the bf16 instance for a bf16
    ``dtype``; returns (3, 3, C, F) f32."""
    _check_cuda(what, dtype, x=x, dy=dy)
    _check_shapes(what, x, dy, stride)
    B, H, W, C = x.shape
    F_ = dy.shape[-1]
    if C % 4 or F_ % 4:
        raise ValueError(f'{what}: channels must be multiples of 4, got C {C}, F {F_}')
    lib = _lib()
    dev = x.device
    tiles = lib.epnet_conv3x3_dw_tiles(C, F_)
    pixels = B * (H // stride) * (W // stride)
    splits = max(1, min(_DW_WAVES * _resident_blocks(dev) // tiles, pixels // _MIN_SPLIT_PIXELS))
    part = torch.empty((splits, 9 * C * F_), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, C, F_), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch = (lib.epnet_conv3x3_dw_bf16_launch if dtype == torch.bfloat16
                  else lib.epnet_conv3x3_dw_launch)
        err = launch(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), B, H, W, C, F_,
                     stride, splits, stream)
    cuda_build.check(lib, err, f'{what} launch')
    return dw


def dw3x3_s2_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel D: the stride-2 weight gradient on the card, kernel E's
    3xTF32 tensor-core kernel at stride 2 (f32 accuracy). x (B, H, W, C)
    and dy (B, H/2, W/2, F) float32, contiguous, on one CUDA device; even
    H and W; C and F multiples of 4. Raises on anything else."""
    dw = _dw_kernel('dw3x3_s2_kernel', x, dy, 2)
    dw3x3_s2_kernel.launches += 1
    return dw


dw3x3_s2_kernel.launches = 0


def dw3x3_s1_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel E: the stride-1 weight gradient on the card (3xTF32 on the
    tensor cores, f32 accuracy). x (B, H, W, C) and dy (B, H, W, F) as for
    ``dw3x3_s2_kernel``."""
    dw = _dw_kernel('dw3x3_s1_kernel', x, dy, 1)
    dw3x3_s1_kernel.launches += 1
    return dw


dw3x3_s1_kernel.launches = 0


def dw3x3_s2_bf16_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel D-bf16: ``dw3x3_s2_kernel`` on bf16 x and dy (8-byte
    aligned), bf16 products on the tensor cores summed in f32; returns the
    (3, 3, C, F) f32 sum."""
    dw = _dw_kernel('dw3x3_s2_bf16_kernel', x, dy, 2, torch.bfloat16)
    dw3x3_s2_bf16_kernel.launches += 1
    return dw


dw3x3_s2_bf16_kernel.launches = 0


def dw3x3_s1_bf16_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel E-bf16: ``dw3x3_s1_kernel`` on bf16 x and dy, as D-bf16."""
    dw = _dw_kernel('dw3x3_s1_bf16_kernel', x, dy, 1, torch.bfloat16)
    dw3x3_s1_bf16_kernel.launches += 1
    return dw


dw3x3_s1_bf16_kernel.launches = 0


def conv3x3_s2_fwd_grid(x_shape, features: int, dev, dtype=torch.float32) -> tuple:
    """(tiles, splits) of kernel F (F-bf16 for a bf16 ``dtype``) for an
    NHWC input of ``x_shape`` on ``dev``: the launch has tiles * splits
    blocks. K is split only when the output tiles fill fewer than
    ``_FWD_WAVES`` waves of resident blocks, and no split keeps fewer than
    ``_MIN_SPLIT_STEPS`` of the kernel's steps (``_BF16_*`` for F-bf16)."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _fwd_grid(*x_shape, features, index, dtype == torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _fwd_grid(B, H, W, C, features, index, bf16) -> tuple:
    """``conv3x3_s2_fwd_grid`` by value, computed once a shape: the bf16
    forward launches F-bf16 on a few shapes again and again, where a kernel
    takes tens of microseconds and the host's time per call counts."""
    lib = _fwd_lib()
    tiles = lib.epnet_conv3x3_s2_fwd_tiles(B, H, W, features)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    if bf16:
        waves = _BF16_WAVES * lib.epnet_conv3x3_s2_fwd_bf16_blocks() * sms
        steps = lib.epnet_conv3x3_s2_fwd_bf16_steps(C) // _BF16_MIN_SPLIT_STEPS
    else:
        waves = _FWD_WAVES * _BLOCKS_PER_SM * sms
        steps = lib.epnet_conv3x3_s2_fwd_steps(C) // _MIN_SPLIT_STEPS
    return tiles, max(1, min(waves // tiles, steps))


def conv3x3_s2_fwd_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel F: the 3x3 SAME stride-2 conv forward on the card (3xTF32 on
    the tensor cores, f32 accuracy). x (B, H, W, C) and w (3, 3, C, F)
    float32, contiguous, on one CUDA device; even H and W; C and F
    multiples of 4. Raises on anything else."""
    y = _launch_conv_fwd('conv3x3_s2_fwd_kernel', 'epnet_conv3x3_s2_fwd_launch', torch.float32,
                         x, w)
    conv3x3_s2_fwd_kernel.launches += 1
    return y


conv3x3_s2_fwd_kernel.launches = 0


def conv3x3_s2_fwd_bf16_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel F-bf16: as ``conv3x3_s2_fwd_kernel`` with x, w and the result
    bf16 (8-byte aligned), on the bf16 tensor cores with f32 accumulation."""
    y = _launch_conv_fwd('conv3x3_s2_fwd_bf16_kernel', 'epnet_conv3x3_s2_fwd_bf16_launch',
                         torch.bfloat16, x, w)
    conv3x3_s2_fwd_bf16_kernel.launches += 1
    return y


conv3x3_s2_fwd_bf16_kernel.launches = 0


def _launch_conv_fwd(what: str, entry: str, dtype, x: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Kernel F's C entry point ``entry`` on x and w of ``dtype``:
    allocates the result (and the f32 split slices; for f32 also the (2, F,
    9C) planes of w's TF32 split), launches, returns it."""
    _check_cuda(what, dtype, x=x, w=w)
    _check_fwd(what, x, w)
    B, H, W, C = x.shape
    F_ = w.shape[-1]
    if C % 4 or F_ % 4:
        raise ValueError(f'{what}: channels must be multiples of 4, got C {C}, F {F_}')
    if B == 0:
        raise ValueError(f'{what}: empty batch')
    lib = _fwd_lib()
    dev = x.device
    _, splits = conv3x3_s2_fwd_grid(x.shape, F_, dev, dtype)
    y = torch.empty((B, H // 2, W // 2, F_), dtype=dtype, device=dev)
    part = (torch.empty((splits, y.numel()), dtype=torch.float32, device=dev) if splits > 1
            else None)
    wt = (None if dtype == torch.bfloat16
          else torch.empty((2, F_, 9 * C), dtype=torch.float32, device=dev))
    # the launch goes to the current device: switch only when x lies elsewhere
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(x.data_ptr(), w.data_ptr(),
                                  *([] if wt is None else [wt.data_ptr()]),
                                  None if part is None else part.data_ptr(),
                                  y.data_ptr(), B, H, W, C, F_, splits, stream)
    cuda_build.check(lib, err, f'{what} launch')
    return y


def _on_device(kernel, plain, a, b):
    if a.is_cuda:
        return kernel(a, b)
    if a.device.type == 'cpu':
        return plain(a, b)
    raise ValueError(f'unsupported device {a.device}')


def conv3x3_s2_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, H/2, W/2, F) 3x3 SAME stride-2 conv: kernel F (F-bf16 for bf16
    tensors) for CUDA tensors, the plain version for CPU tensors."""
    kernel = conv3x3_s2_fwd_bf16_kernel if x.dtype == torch.bfloat16 else conv3x3_s2_fwd_kernel
    return _on_device(kernel, conv3x3_s2_fwd_plain, x, w)


def dw3x3_s2(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) f32 stride-2 weight gradient: kernel D (D-bf16 for bf16
    tensors) for CUDA tensors, the plain version for CPU tensors."""
    kernel = dw3x3_s2_bf16_kernel if x.dtype == torch.bfloat16 else dw3x3_s2_kernel
    return _on_device(kernel, dw3x3_s2_plain, x, dy)


def dw3x3_s1(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) f32 stride-1 weight gradient: kernel E (E-bf16 for bf16
    tensors) for CUDA tensors, the plain version for CPU tensors."""
    kernel = dw3x3_s1_bf16_kernel if x.dtype == torch.bfloat16 else dw3x3_s1_kernel
    return _on_device(kernel, dw3x3_s1_plain, x, dy)


class _Conv3x3Same(torch.autograd.Function):
    """Saves the NHWC input (for dw), the HWIO weight and, at stride 1, the
    padded NCHW input (for dx, the convolution backward that autograd runs
    for ``nn.Conv2d``)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.stride = stride
        if stride == 2:
            ctx.save_for_backward(x, w)
            return conv3x3_s2_fwd(x.contiguous(), w.contiguous())
        x_nchw = x.permute(0, 3, 1, 2)
        xp = F.pad(x_nchw, _nchw_pads(x_nchw, 3, stride))
        ctx.save_for_backward(x, w, xp)
        return F.conv2d(xp, w.permute(3, 2, 0, 1), None, (stride, stride)).permute(0, 2, 3, 1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w, *saved = ctx.saved_tensors
        s = ctx.stride
        dx = dw = None
        if ctx.needs_input_grad[0]:
            B, H, W, C = x.shape
            left, right, top, bottom = _nchw_pads(x.permute(0, 3, 1, 2), 3, s)
            # the stride-2 forward made no padded copy; for dx the convolution
            # backward reads only its input's shape (as torch.nn.grad.conv2d_input)
            xp = saved[0] if saved else x.new_empty(1).expand(B, C, H + top + bottom,
                                                              W + left + right)
            dxp = torch.ops.aten.convolution_backward(
                dy.permute(0, 3, 1, 2), xp, w.permute(3, 2, 0, 1), None, (s, s), (0, 0),
                (1, 1), False, (0, 0), 1, (True, False, False))[0]
            dx = dxp[:, :, top:top + H, left:left + W].permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = (dw3x3_s2 if s == 2 else dw3x3_s1)(x.contiguous(), dy.contiguous()).to(w.dtype)
        return dx, dw, None


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B, H, W, C), w (3, 3, C, F) -> (B, H', W', F): a SAME 3x3 conv
    with stride 1 or 2, differentiable in both. The stride-2 forward is
    kernel F and the weight gradient kernel D or E on the card; on the CPU
    their plain versions. x and w share a dtype, f32 or bf16 (F-bf16 at
    stride 2, D-bf16 and E-bf16 for dw)."""
    if x.dtype != w.dtype:
        raise TypeError(f'conv3x3_same: x is {x.dtype}, w {w.dtype}')
    if stride not in (1, 2) or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f'conv3x3_same: x {tuple(x.shape)}, w {tuple(w.shape)}, '
                         f'stride {stride}')
    return _Conv3x3Same.apply(x, w, stride)
