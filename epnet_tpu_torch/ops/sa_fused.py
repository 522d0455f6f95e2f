"""Fused set-abstraction interior (gather + 3-layer ReLU MLP + sample max)
with its gradient: the CUDA kernels ``csrc/sa_fused.cu`` (forward) and
``csrc/sa_fused_bwd.cu`` (backward by recompute), and their plain PyTorch
versions.

The kernels replace the Pallas TPU kernels
``epnet_tpu/ops/sa_fused.py::_fwd_kernel`` and ``::_bwd_kernel`` (f32).
What bounds them on the H100, and what their designs do about that, is
written at the top of each source: the dense layers' FFMA work, with every
intermediate kept in shared memory and registers.

Layer 1 commutes with the gather when the stage has no BatchNorm, so the
caller passes ``y = [xyz, feats] @ W1 + b1`` over each table and
``o = new_xyz @ W1[:3]`` per centroid (``models/pointnet2.py``), as the JAX
package does.

``fused_point_mlp_max`` is differentiable in every input but ``idx``. Like
the JAX custom VJP it saves only its inputs and recomputes the rows in the
backward, so nothing of size (T, M*S, C) is kept between the two. The
gradient of the sample max is split evenly among tied rows. Both
directions launch the kernels for CUDA tensors and run the plain versions
only for CPU tensors; there is no fallback between the two.
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


def fused_point_mlp_max_bwd_plain(y, o, idx, w2, b2, w3, b3, gout):
    """Gradients of ``fused_point_mlp_max_plain`` by recompute, written out:
    gather, the three layers, the max gradient split evenly among tied rows,
    the two layers back, and an ``index_add_`` for the scatter into ``y``.

    :param gout: (T, M, C3) gradient of the output
    :return: dy (T, N, C1), do (T, M, C1), dw2, db2, dw3, db3
    """
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C2, C3 = w2.shape[-1], w3.shape[-1]
    g = torch.gather(y, 1, idx.reshape(T, M * S, 1).expand(T, M * S, C1))
    g1 = g.reshape(T, M, S, C1) - o[:, :, None, :]
    h1 = torch.relu(g1)
    p2 = h1 @ w2 + b2
    h2 = torch.relu(p2)
    p3 = h2 @ w3 + b3
    h3 = torch.relu(p3)
    ties = (h3 == h3.amax(dim=2, keepdim=True)).to(h3.dtype)
    dh3 = ties * (gout[:, :, None, :] / ties.sum(dim=2, keepdim=True))
    dp3 = torch.where(p3 > 0, dh3, 0.0)
    dw3 = h2.reshape(-1, C2).t() @ dp3.reshape(-1, C3)
    db3 = dp3.sum(dim=(0, 1, 2))
    dp2 = torch.where(p2 > 0, dp3 @ w3.t(), 0.0)
    dw2 = h1.reshape(-1, C1).t() @ dp2.reshape(-1, C2)
    db2 = dp2.sum(dim=(0, 1, 2))
    dp1 = torch.where(g1 > 0, dp2 @ w2.t(), 0.0)
    rows = (idx + N * torch.arange(T, device=idx.device)[:, None, None]).reshape(-1)
    dy = torch.zeros_like(y).reshape(T * N, C1).index_add_(0, rows, dp1.reshape(-1, C1))
    return dy.reshape(T, N, C1), -dp1.sum(dim=2), dw2, db2, dw3, db3


_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _typed(lib: ctypes.CDLL, fns: dict) -> ctypes.CDLL:
    if not getattr(lib, '_epnet_typed', False):
        for name, (argtypes, restype) in fns.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
        lib._epnet_typed = True
    return lib


def _fwd_lib() -> ctypes.CDLL:
    return _typed(cuda_build.load_library('sa_fused'), {
        'epnet_sa_fused_fwd_launch':
            ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
        'epnet_sa_fused_smem_bytes': ([ctypes.c_int] * 4, ctypes.c_longlong)})


def _bwd_lib() -> ctypes.CDLL:
    return _typed(cuda_build.load_library('sa_fused_bwd'), {
        'epnet_sa_fused_bwd_launch':
            ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p], ctypes.c_int),
        'epnet_sa_fused_bwd_smem_bytes': ([ctypes.c_int] * 3, ctypes.c_longlong),
        'epnet_sa_fused_bwd_partial_floats': ([ctypes.c_int] * 3, ctypes.c_longlong)})


def _check_args(what: str, **tensors):
    """Device, dtype and shape checks shared by both kernels' wrappers;
    returns (T, N, M, S, C1, C2, C3)."""
    dev = tensors['y'].device
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f'{what}: {name} must be on {dev} (CUDA), got {t.device}')
        want = torch.int64 if name == 'idx' else torch.float32
        if t.dtype != want:
            raise TypeError(f'{what}: {name} must be {want}, got {t.dtype}')
    y, o, idx = tensors['y'], tensors['o'], tensors['idx']
    w2, b2, w3, b3 = tensors['w2'], tensors['b2'], tensors['w3'], tensors['b3']
    if y.dim() != 3 or o.dim() != 3 or idx.dim() != 3:
        raise ValueError(f'{what}: y, o and idx must be rank 3')
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C2, C3 = w2.shape[-1], w3.shape[-1]
    gout = tensors.get('gout')
    if (o.shape != (T, M, C1) or idx.shape[0] != T or w2.shape != (C1, C2)
            or b2.shape != (C2,) or w3.shape != (C2, C3) or b3.shape != (C3,)
            or (gout is not None and gout.shape != (T, M, C3))):
        raise ValueError(f'{what}: shape mismatch: '
                         + ' '.join(f'{k} {tuple(v.shape)}' for k, v in tensors.items()))
    if min(N, S, C1, C2, C3) <= 0:
        raise ValueError(f'{what}: empty table, sample or channel axis')
    return T, N, M, S, C1, C2, C3


def fused_point_mlp_max_kernel(y, o, idx, w2, b2, w3, b3):
    """Launch ``csrc/sa_fused.cu`` on the current stream. All tensors on one
    CUDA device, float32 (idx int64), shapes as in the plain version.
    Raises on anything the kernel does not take."""
    T, N, M, S, C1, C2, C3 = _check_args('fused_point_mlp_max_kernel', y=y, o=o, idx=idx,
                                         w2=w2, b2=b2, w3=w3, b3=b3)
    lib = _fwd_lib()
    smem = lib.epnet_sa_fused_smem_bytes(S, C1, C2, C3)
    if smem > _SMEM_LIMIT:
        raise ValueError(f'fused SA kernel needs {smem} B of shared memory at '
                         f'C1/C2/C3 = {C1}/{C2}/{C3}; the limit is {_SMEM_LIMIT}')
    dev = y.device
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

_BWD_ROWS = 64  # rows of one chunk of csrc/sa_fused_bwd.cu: a centroid must fit


def fused_point_mlp_max_bwd_kernel(y, o, idx, w2, b2, w3, b3, gout):
    """Launch ``csrc/sa_fused_bwd.cu`` (and its fixed-order reduction of the
    per-block dW/db slices) on the current stream. Tensors as in
    ``fused_point_mlp_max_bwd_plain``, on one CUDA device; S <= 64.
    Returns (dy, do, dw2, db2, dw3, db3). Raises on anything the kernel
    does not take."""
    T, N, M, S, C1, C2, C3 = _check_args('fused_point_mlp_max_bwd_kernel', y=y, o=o,
                                         idx=idx, w2=w2, b2=b2, w3=w3, b3=b3, gout=gout)
    if S > _BWD_ROWS:
        raise ValueError(f'fused SA backward kernel takes at most {_BWD_ROWS} samples '
                         f'a centroid, got {S}')
    lib = _bwd_lib()
    smem = lib.epnet_sa_fused_bwd_smem_bytes(C1, C2, C3)
    if smem + 1024 > _SMEM_LIMIT:
        raise ValueError(f'fused SA backward kernel needs {smem} B of shared memory at '
                         f'C1/C2/C3 = {C1}/{C2}/{C3}; the limit is {_SMEM_LIMIT}')
    dev = y.device
    args = [t.detach().contiguous() for t in (y, o, idx, w2, b2, w3, b3, gout)]
    units = T * -(-M // (_BWD_ROWS // S))
    blocks = max(1, min(units, 2 * torch.cuda.get_device_properties(dev).multi_processor_count))
    size = lib.epnet_sa_fused_bwd_partial_floats(C1, C2, C3)
    dy = torch.zeros((T, N, C1), dtype=torch.float32, device=dev)
    do = torch.empty((T, M, C1), dtype=torch.float32, device=dev)
    part = torch.empty((blocks, size), dtype=torch.float32, device=dev)
    grads = torch.empty((size,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.epnet_sa_fused_bwd_launch(
            *(a.data_ptr() for a in args), dy.data_ptr(), do.data_ptr(), part.data_ptr(),
            grads.data_ptr(), T, N, M, S, C1, C2, C3, blocks, stream)
    cuda_build.check(lib, err, 'fused SA backward kernel launch')
    fused_point_mlp_max_bwd_kernel.launches += 1
    dw2, db2, dw3, db3 = torch.split(grads, [C1 * C2, C2, C2 * C3, C3])
    return dy, do, dw2.view(C1, C2), db2, dw3.view(C2, C3), db3


fused_point_mlp_max_bwd_kernel.launches = 0


class _FusedPointMlpMax(torch.autograd.Function):
    """Forward and backward by kernel on CUDA, by plain version on the CPU;
    saves only the inputs."""

    @staticmethod
    def forward(ctx, y, o, idx, w2, b2, w3, b3):
        ctx.save_for_backward(y, o, idx, w2, b2, w3, b3)
        if y.is_cuda:
            return fused_point_mlp_max_kernel(y, o, idx, w2, b2, w3, b3)
        return fused_point_mlp_max_plain(y, o, idx, w2, b2, w3, b3)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        args = ctx.saved_tensors
        if gout.is_cuda:
            grads = fused_point_mlp_max_bwd_kernel(*args, gout)
        else:
            grads = fused_point_mlp_max_bwd_plain(*args, gout)
        dy, do, dw2, db2, dw3, db3 = grads
        return dy, do, None, dw2, db2, dw3, db3


def fused_point_mlp_max(y, o, idx, w2, b2, w3, b3):
    """(T, M, C3) fused SA interior, differentiable in every input but
    ``idx``: the CUDA kernels for CUDA tensors, the plain versions for CPU
    tensors."""
    if y.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'fused_point_mlp_max: unsupported device {y.device}')
    return _FusedPointMlpMax.apply(y, o, idx, w2, b2, w3, b3)
