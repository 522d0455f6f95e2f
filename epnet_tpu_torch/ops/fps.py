"""Exact furthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its
plain PyTorch version.

The kernel replaces the Pallas TPU kernels
``epnet_tpu/ops/fps_pallas.py::_fps_kernel_vec`` and ``::_fps_kernel``.
What bounds it on the H100, and what its design does about that, is
written at the top of ``csrc/fps.cu``: a latency-bound chain of npoint-1
argmax steps; a large cloud spread over a thread-block cluster, every point
and its running distance in registers, the argmax a max over packed
(distance, index) keys combined across the cluster through distributed
shared memory with one cluster barrier a step.

``furthest_point_sample`` launches the kernel for a CUDA tensor and runs the
plain version only for a CPU tensor; there is no fallback between the two.
With ``groups`` above 1 it is the JAX package's partitioned FPS
(``pointops.py:198-232``): exact FPS on each of ``groups`` interleaved
index slices of every cloud, all sub-clouds in one call.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The JAX reference loop (``pointops.furthest_point_sample_xla``) on any
    device: (B, N, 3) -> (B, npoint) int64, index 0 first, lowest index on
    ties. The distance is written out elementwise so every operation rounds
    on its own, as the kernel's does."""
    B, N, _ = xyz.shape
    xyz = xyz.detach()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    min_d = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    last = torch.zeros((B, 1), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        d = dx * dx + dy * dy + dz * dz
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=1, keepdim=True)  # first max on ties
        idxs[:, j] = last[:, 0]
    return idxs


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library('fps')
    if not getattr(lib, '_epnet_typed', False):
        lib.epnet_fps_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.epnet_fps_launch.restype = ctypes.c_int
        lib.epnet_fps_config.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
        lib.epnet_fps_config.restype = None
        lib.epnet_fps_max_points.argtypes = []
        lib.epnet_fps_max_points.restype = ctypes.c_int
        lib._epnet_typed = True
    return lib


def kernel_config(n: int) -> tuple:
    """(blocks a cloud, threads a block) that ``csrc/fps.cu`` launches for
    clouds of ``n`` points: above one block a cloud, a thread-block
    cluster. Chosen by the cloud's size alone."""
    cs, threads = ctypes.c_int(), ctypes.c_int()
    _lib().epnet_fps_config(n, ctypes.byref(cs), ctypes.byref(threads))
    return cs.value, threads.value


def furthest_point_sample_kernel(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Launch ``csrc/fps.cu`` on the current stream: (B, N, 3) float32 CUDA
    -> (B, npoint) int64, in ``kernel_config(N)``. Raises on anything the
    kernel does not take."""
    if not xyz.is_cuda:
        raise ValueError(f'furthest_point_sample_kernel needs a CUDA tensor, got {xyz.device}')
    if xyz.dtype != torch.float32:
        raise TypeError(f'furthest_point_sample_kernel takes float32, got {xyz.dtype}')
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f'expected (B, N, 3), got {tuple(xyz.shape)}')
    B, N, _ = xyz.shape
    if not 0 < npoint <= N:
        raise ValueError(f'npoint must lie in [1, {N}], got {npoint}')
    lib = _lib()
    if N > lib.epnet_fps_max_points():
        raise ValueError(f'fps kernel takes at most {lib.epnet_fps_max_points()} '
                         f'points a cloud, got {N}')
    xyz = xyz.detach().contiguous()
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    if B == 0:
        return out
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        err = lib.epnet_fps_launch(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
    cuda_build.check(lib, err, 'fps kernel launch')
    furthest_point_sample_kernel.launches += 1
    return out


furthest_point_sample_kernel.launches = 0


def furthest_point_sample(xyz: torch.Tensor, npoint: int, groups: int = 1) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int64 exact FPS indices: the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor.

    ``groups`` above 1 (``RPN.FPS_GROUPS``) is partitioned FPS, where
    ``N`` and ``npoint`` divide into the groups (else plain FPS over the
    cloud, as JAX): point ``n`` belongs to group ``n % groups``, each group
    is a sub-cloud of N / groups points that gives npoint / groups exact
    FPS picks, and the B x groups sub-clouds go through one call. Local
    pick ``l`` of group ``g`` is point ``l * groups + g``; the rounds are
    interleaved (pick ``j * groups + g`` is group g's j-th), so every
    prefix holds as many picks of each group."""
    B, N = xyz.shape[0], xyz.shape[1]
    if groups > 1 and N % groups == 0 and npoint % groups == 0:
        sub = xyz.reshape(B, N // groups, groups, xyz.shape[-1]).transpose(1, 2)
        loc = furthest_point_sample(sub.reshape(B * groups, N // groups, xyz.shape[-1]),
                                    npoint // groups)
        g = torch.arange(groups, device=loc.device)[None, :, None]
        glob = loc.reshape(B, groups, npoint // groups) * groups + g
        return glob.transpose(1, 2).reshape(B, npoint)
    if xyz.is_cuda:
        return furthest_point_sample_kernel(xyz, npoint)
    if xyz.device.type != 'cpu':
        raise ValueError(f'furthest_point_sample: unsupported device {xyz.device}')
    return furthest_point_sample_plain(xyz, npoint)
