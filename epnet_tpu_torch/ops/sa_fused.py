"""Fused set-abstraction interior (gather + 3-layer ReLU MLP + sample max):
the CUDA kernel ``csrc/sa_fused.cu`` and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel
``epnet_tpu/ops/sa_fused.py::_fwd_kernel`` (f32, forward only). What bounds
it on the H100, and what its design does about that, is written at the top
of ``csrc/sa_fused.cu``: the two dense layers' FFMA work, with every
intermediate kept in shared memory and registers.

Layer 1 commutes with the gather when the stage has no BatchNorm, so the
caller passes ``y = [xyz, feats] @ W1 + b1`` over each table and
``o = new_xyz @ W1[:3]`` per centroid (``models/pointnet2.py``), as the JAX
package does.

``fused_point_mlp_max`` launches the kernel for CUDA tensors and runs the
plain version only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def fused_point_mlp_max_plain(y, o, idx, w2, b2, w3, b3):
    """``max_s relu(relu(relu(y[idx] - o) @ w2 + b2) @ w3 + b3)`` on any
    device: gather, three matmuls with ReLU, then the max.

    :param y: (T, N, C1); o: (T, M, C1); idx: (T, M, S) int64
    :param w2: (C1, C2); b2: (C2,); w3: (C2, C3); b3: (C3,)
    :return: (T, M, C3)
    """
    T, N, C1 = y.shape
    _, M, S = idx.shape
    g = torch.gather(y, 1, idx.reshape(T, M * S, 1).expand(T, M * S, C1))
    h1 = torch.relu(g.reshape(T, M, S, C1) - o[:, :, None, :])
    h2 = torch.relu(h1 @ w2 + b2)
    h3 = torch.relu(h2 @ w3 + b3)
    return h3.amax(dim=2)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library('sa_fused')
    if not getattr(lib, '_epnet_typed', False):
        lib.epnet_sa_fused_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.epnet_sa_fused_fwd_launch.restype = ctypes.c_int
        lib.epnet_sa_fused_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.epnet_sa_fused_smem_bytes.restype = ctypes.c_longlong
        lib._epnet_typed = True
    return lib


_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def fused_point_mlp_max_kernel(y, o, idx, w2, b2, w3, b3):
    """Launch ``csrc/sa_fused.cu`` on the current stream. All tensors on one
    CUDA device, float32 (idx int64), shapes as in the plain version.
    Raises on anything the kernel does not take."""
    tensors = dict(y=y, o=o, idx=idx, w2=w2, b2=b2, w3=w3, b3=b3)
    dev = y.device
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f'fused_point_mlp_max_kernel: {name} must be on {dev} '
                             f'(CUDA), got {t.device}')
        want = torch.int64 if name == 'idx' else torch.float32
        if t.dtype != want:
            raise TypeError(f'fused_point_mlp_max_kernel: {name} must be {want}, '
                            f'got {t.dtype}')
    if y.dim() != 3 or o.dim() != 3 or idx.dim() != 3:
        raise ValueError('y, o and idx must be rank 3')
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C2, C3 = w2.shape[-1], w3.shape[-1]
    if (o.shape != (T, M, C1) or idx.shape[0] != T or w2.shape != (C1, C2)
            or b2.shape != (C2,) or w3.shape != (C2, C3) or b3.shape != (C3,)):
        raise ValueError(
            f'shape mismatch: y {tuple(y.shape)} o {tuple(o.shape)} idx '
            f'{tuple(idx.shape)} w2 {tuple(w2.shape)} b2 {tuple(b2.shape)} '
            f'w3 {tuple(w3.shape)} b3 {tuple(b3.shape)}')
    lib = _lib()
    if min(N, S, C1, C2, C3) <= 0:
        raise ValueError('empty table, sample or channel axis')
    smem = lib.epnet_sa_fused_smem_bytes(S, C1, C2, C3)
    if smem > _SMEM_LIMIT:
        raise ValueError(f'fused SA kernel needs {smem} B of shared memory at '
                         f'C1/C2/C3 = {C1}/{C2}/{C3}; the limit is {_SMEM_LIMIT}')
    args = [t.detach().contiguous() for t in (y, o, idx, w2, b2, w3, b3)]
    out = torch.empty((T, M, C3), dtype=torch.float32, device=dev)
    if T == 0 or M == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.epnet_sa_fused_fwd_launch(*(a.data_ptr() for a in args),
                                            out.data_ptr(), T, N, M, S, C1, C2,
                                            C3, stream)
    cuda_build.check(lib, err, 'fused SA kernel launch')
    fused_point_mlp_max_kernel.launches += 1
    return out


fused_point_mlp_max_kernel.launches = 0


def fused_point_mlp_max(y, o, idx, w2, b2, w3, b3):
    """(T, M, C3) fused SA interior: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Forward only: the backward kernel is not
    ported, so a call that would record a gradient raises on every device
    rather than differ between them."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, o, w2, b2, w3, b3)):
        raise NotImplementedError('fused_point_mlp_max has no backward yet; '
                                  'call it under torch.no_grad()')
    if y.is_cuda:
        return fused_point_mlp_max_kernel(y, o, idx, w2, b2, w3, b3)
    if y.device.type != 'cpu':
        raise ValueError(f'fused_point_mlp_max: unsupported device {y.device}')
    return fused_point_mlp_max_plain(y, o, idx, w2, b2, w3, b3)
