"""Fused set-abstraction interior (gather + 3-layer ReLU MLP + sample max)
with its gradient: the CUDA kernels ``csrc/sa_fused.cu`` (forward) and
``csrc/sa_fused_bwd.cu`` (backward by recompute), and their plain PyTorch
versions, in two forms: rows by table index (kernels B and C), and rows by
window-relative index, a window per tile of centroids (kernels G and H,
the block-local RCNN stage).

The kernels replace the Pallas TPU kernels
``epnet_tpu/ops/sa_fused.py::_fwd_kernel`` and ``::_bwd_kernel`` (B, C) and
``::_fwd_kernel_win`` and ``::_bwd_kernel_win`` (G, H), f32. All four also
take bf16 ``y``, ``o``, ``w2`` and ``w3`` (f32 ``b2`` and ``b3``): the Pallas
kernels' ``n_splits == 1`` branch (``sa_fused.py:91-93,108-116,148-149``;
the backwards' ``:194-196,207-243,438-440,479``) that the JAX package's
``MIXED_PRECISION`` forward and train step reach
(``models/pointnet2.py:271-289``): B-bf16, G-bf16 (returning bf16) and
C-bf16, H-bf16 (returning the f32 sums, which the custom VJP casts to the
inputs' dtypes, ``:306-319``: ``cast_grads``). The forward also replaces
the two profiler kernels of the same function,
``tools/profile_fused_onehot.py::kern`` and
``tools/profile_fps_variants.py::kernel`` (with ``w3 = w2``, ``b3 = b2``).
In bf16 every product accumulates in f32, and h1 and h2 are rounded to
bf16 before the next layer, where the Pallas kernels cast them; the
backward also rounds dp3 and dp2 before their products and dp1 before
the scatter, sample by sample. What bounds the kernels on the H100, and what
their designs do about that, is written at the top of each source: the
dense layers' work, with every intermediate kept in shared memory and
registers. B, G, C and H take each ball's distinct rows once and run
their products, or those that decide nothing, in three TF32 passes on the
tensor cores (S <= 64, C1 and C2 <= 128: ``check_rows_takes``); G is B's
kernel after a dedupe that reads the rows through the windows. B-bf16 and
G-bf16 are one kernel on the distinct rows, bf16 ``wgmma`` with W2 and W3
resident in shared memory: B's limits and C3 <= 256
(``check_bf16_takes``). C-bf16 and H-bf16 are one kernel too, with the
recompute on bf16 ``wgmma`` and every rounding, mask and max it decides
certified against a bound on the tensor cores' error (the few uncertain
ones summed again in the plain version's order). A stage beyond a
kernel's limits raises on the card.

Layer 1 commutes with the gather when the stage has no BatchNorm, so the
caller passes ``y = [xyz, feats] @ W1 + b1`` over each table and
``o = new_xyz @ W1[:3]`` per centroid (``models/pointnet2.py``), as the JAX
package does.

``fused_point_mlp_max`` is differentiable in every input but ``idx`` (and
``fused_point_mlp_max_win`` in every input but ``idx_rel`` and ``starts``). Like
the JAX custom VJP it saves only its inputs and recomputes the rows in the
backward, so nothing of size (T, M*S, C) is kept between the two. The
gradient of the sample max is split evenly among tied rows. Both
directions launch the kernels for CUDA tensors and run the plain versions
only for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import cuda_build


def fused_point_mlp_max_plain(y, o, idx, w2, b2, w3, b3):
    """``max_s relu(relu(relu(y[idx] - o) @ w2 + b2) @ w3 + b3)`` on any
    device: gather, three matmuls with ReLU, then the max.

    With bf16 ``y``, ``o``, ``w2`` and ``w3`` (``b2``, ``b3`` f32) it is the
    Pallas kernel's bf16 function (``sa_fused.py:91-93,106-120``): h1 =
    relu(y[idx] - o) in f32, rounded to bf16; each layer multiplies bf16
    operands in f32 (their products are exact there) and adds its f32
    bias; h2 is rounded to bf16 before layer 3; the max is taken in f32 and
    the output rounded to bf16.

    :param y: (T, N, C1); o: (T, M, C1); idx: (T, M, S) int64
    :param w2: (C1, C2); b2: (C2,); w3: (C2, C3); b3: (C3,)
    :return: (T, M, C3) in y's dtype
    """
    T, N, C1 = y.shape
    _, M, S = idx.shape
    g = torch.gather(y, 1, idx.reshape(T, M * S, 1).expand(T, M * S, C1))
    if y.dtype == torch.bfloat16:
        def op(t):  # an operand as bf16 holds it, in f32
            return t.to(torch.bfloat16).float()
        h1 = op(torch.relu(g.reshape(T, M, S, C1).float() - o.float()[:, :, None, :]))
        h2 = op(torch.relu(h1 @ w2.float() + b2))
        h3 = torch.relu(h2 @ w3.float() + b3)
        return h3.amax(dim=2).to(torch.bfloat16)
    h1 = torch.relu(g.reshape(T, M, S, C1) - o[:, :, None, :])
    h2 = torch.relu(h1 @ w2 + b2)
    h3 = torch.relu(h2 @ w3 + b3)
    return h3.amax(dim=2)


def fused_point_mlp_max_bwd_plain(y, o, idx, w2, b2, w3, b3, gout):
    """Gradients of ``fused_point_mlp_max_plain`` by recompute, written out:
    gather, the three layers, the max gradient split evenly among tied rows,
    the two layers back, and an ``index_add_`` for the scatter into ``y``.

    With bf16 ``y``, ``o``, ``w2`` and ``w3`` it is C-bf16's function, the
    Pallas kernel's ``n_splits == 1`` branch (``sa_fused.py:194-243``),
    sample by sample: the recompute rounds as the bf16 forward (h1, h2); dp3
    and dp2 are rounded to bf16 for the products that take them (dW3, dh2;
    dW2, dh1) and dp1 before the scatter into dy; every product sums in
    f32, and db, do and dy's sums stay f32.

    :param gout: (T, M, C3) float32 gradient of the output
    :return: the f32 sums dy (T, N, C1), do (T, M, C1), dw2, db2, dw3, db3
        (``cast_grads`` gives them the inputs' dtypes)
    """
    if y.dtype == torch.bfloat16:
        return _bwd_bf16_plain(y, o, idx, w2, b2, w3, b3, gout)
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


def _bwd_bf16_plain(y, o, idx, w2, b2, w3, b3, gout):
    """``fused_point_mlp_max_bwd_plain`` on bf16 operands."""
    def r(t):  # rounded to bf16, held in f32
        return t.to(torch.bfloat16).float()
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C2, C3 = w2.shape[-1], w3.shape[-1]
    w2f, w3f = w2.float(), w3.float()
    g = torch.gather(y.float(), 1, idx.reshape(T, M * S, 1).expand(T, M * S, C1))
    g1 = g.reshape(T, M, S, C1) - o.float()[:, :, None, :]
    h1 = r(torch.relu(g1))
    p2 = h1 @ w2f + b2
    h2 = r(torch.relu(p2))
    p3 = h2 @ w3f + b3
    h3 = torch.relu(p3)
    ties = (h3 == h3.amax(dim=2, keepdim=True)).float()
    dp3 = torch.where(p3 > 0, ties * (gout[:, :, None, :] / ties.sum(dim=2, keepdim=True)), 0.0)
    dp3c = r(dp3)
    dw3 = h2.reshape(-1, C2).t() @ dp3c.reshape(-1, C3)
    dp2 = torch.where(p2 > 0, dp3c @ w3f.t(), 0.0)
    dp2c = r(dp2)
    dw2 = h1.reshape(-1, C1).t() @ dp2c.reshape(-1, C2)
    dp1 = torch.where(g1 > 0, dp2c @ w2f.t(), 0.0)
    rows = (idx + N * torch.arange(T, device=idx.device)[:, None, None]).reshape(-1)
    dy = torch.zeros((T * N, C1), dtype=torch.float32, device=y.device).index_add_(
        0, rows, r(dp1).reshape(-1, C1))
    return (dy.reshape(T, N, C1), -dp1.sum(dim=2), dw2, dp2.sum(dim=(0, 1, 2)), dw3,
            dp3.sum(dim=(0, 1, 2)))


def cast_grads(grads, y, o, w2, b2, w3, b3):
    """The backward's f32 sums (dy, do, dw2, db2, dw3, db3) cast to the
    dtypes of y, o, w2, b2, w3 and b3, as the custom VJP casts them
    (``sa_fused.py:306-319``); a no-op in f32."""
    return tuple(g.to(t.dtype) for g, t in zip(grads, (y, o, w2, b2, w3, b3)))


def _typed(lib: ctypes.CDLL, fns: dict) -> ctypes.CDLL:
    if not getattr(lib, '_epnet_typed', False):
        for name, (argtypes, restype) in fns.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
        lib._epnet_typed = True
    return lib


def _fwd_lib() -> ctypes.CDLL:
    rows = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int)
    win = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p], ctypes.c_int)
    return _typed(cuda_build.load_library('sa_fused'), {
        'epnet_sa_fused_fwd_launch': rows, 'epnet_sa_fused_fwd_bf16_launch': rows,
        'epnet_sa_fused_win_fwd_launch': win, 'epnet_sa_fused_win_fwd_bf16_launch': win,
        'epnet_sa_fused_bf16_design': ([], ctypes.c_char_p)})


def bf16_design() -> str:
    """What B-bf16 and G-bf16 run, as the built library says (needs nvcc)."""
    return _fwd_lib().epnet_sa_fused_bf16_design().decode()


def _bwd_lib() -> ctypes.CDLL:
    def entry(pointers, ints):
        return ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p],
                ctypes.c_int)
    return _typed(cuda_build.load_library('sa_fused_bwd'), {
        'epnet_sa_fused_bwd_launch': entry(17, 6), 'epnet_sa_fused_bwd_bf16_launch': entry(16, 6),
        'epnet_sa_fused_win_bwd_launch': entry(18, 8),
        'epnet_sa_fused_win_bwd_bf16_launch': entry(17, 8),
        'epnet_sa_wgmma_sum_probe': entry(3, 1),
        'epnet_sa_fused_bwd_bf16_gamma': ([ctypes.c_int], ctypes.c_float),
        'epnet_sa_fused_bwd_partial_floats': ([ctypes.c_int], ctypes.c_longlong),
        'epnet_sa_fused_bwd_counts_ints': ([ctypes.c_int, ctypes.c_int], ctypes.c_longlong)})


_OPERANDS = ('y', 'o', 'w2', 'w3')  # in the operand type; biases and gout stay f32


def _check_args(what: str, dtype=torch.float32, **tensors):
    """Device, dtype and shape checks shared by the kernels' wrappers:
    ``y``, ``o``, ``w2`` and ``w3`` in ``dtype``, the indices int64, the
    rest f32; returns (T, N, M, S, C1, C2, C3)."""
    dev = tensors['y'].device
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f'{what}: {name} must be on {dev} (CUDA), got {t.device}')
        want = (torch.int64 if name in ('idx', 'starts')
                else dtype if name in _OPERANDS else torch.float32)
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


def _check_window(what: str, starts, window: int, T: int, N: int, M: int) -> int:
    """The windowed kernels' extra checks; returns NB, the tiles a table."""
    if starts.dim() != 2 or starts.shape[0] != T:
        raise ValueError(f'{what}: starts must be ({T}, NB), got {tuple(starts.shape)}')
    NB = starts.shape[1]
    if NB <= 0 or M % NB:
        raise ValueError(f'{what}: {NB} window tiles do not divide {M} centroids')
    if not 0 < window <= N:
        raise ValueError(f'{what}: window {window} must lie in [1, {N}]')
    return NB


_ROWS = 64  # samples a ball of the kernels on distinct rows: one warp's sort of its rows
_WIDTH = 128  # their C1 and C2, and the column pass of C3


def check_rows_takes(what, T, N, S, C1, C2):
    """Raise unless kernels B, G, C and H take these shapes: S <= 64, C1 and
    C2 <= 128, N < 2^24 and T * N < 2^31 (a row and its table's offset in
    int32, a row and its multiplicity in 24 + 7 bits)."""
    if S > _ROWS:
        raise ValueError(f'{what}: the kernel takes at most {_ROWS} samples a centroid, '
                         f'got {S}')
    if C1 > _WIDTH or C2 > _WIDTH:
        raise ValueError(f'{what}: the kernel takes C1, C2 <= {_WIDTH}, got {C1}/{C2}')
    if N >= 1 << 24 or T * N >= 1 << 31:
        raise ValueError(f'{what}: tables of at most 2^24 - 1 rows and 2^31 - 1 rows in all, '
                         f'got {T} x {N}')


def check_bf16_takes(what, T, N, S, C1, C2, C3):
    """Raise unless B-bf16 and G-bf16 take these shapes: kernel B's
    (``check_rows_takes``) and C3 <= 256, since W2 and W3 stay in shared
    memory (32 + 64 KB in bf16 at C3 = 256). These are the backward's
    limits too (``check_bwd_takes``)."""
    check_bwd_takes(what, T, N, S, C1, C2, C3)


def _count_rows(direction, counts, cents, S):
    """When tracing: the dedupe's distinct rows (the first ``cents``
    entries of its ``counts`` scratch, summed at the snapshot) and the rows
    the balls gather, ``cents * S``, as ``sa_rows_distinct.<direction>``
    and ``sa_rows_gathered.<direction>``."""
    if trace.on():
        trace.count('sa_rows_distinct.' + direction, counts[:cents])
        trace.count('sa_rows_gathered.' + direction, cents * S)


def _launch_rows(wrapper, entry, dims, inputs, extra=()):
    """Kernel B, G, B-bf16 or G-bf16 (C entry point ``entry``) for ``wrapper``,
    whose launch count it keeps: pads C1 and C2 to 128 and W3's columns to a
    multiple of 128 with zeros (which changes no output), allocates the
    output in y's dtype and the dedupe's scratch, launches, returns (T, M,
    C3). ``inputs``: y, o, idx, [starts,] w2, b2, w3, b3; ``extra``: the ints
    the entry point takes after c3p (G's and G-bf16's nb, window)."""
    what = wrapper.__name__
    T, N, M, S, C1, C2, C3 = dims
    C3P = -(-C3 // _WIDTH) * _WIDTH
    lib = _fwd_lib()
    dev = inputs[0].device
    y, o, idx, *starts, w2, b2, w3, b3 = [t.detach().contiguous() for t in inputs]
    y, o = _pad_to(y, _WIDTH), _pad_to(o, _WIDTH)
    w2, b2 = _pad_to(w2, _WIDTH, _WIDTH), _pad_to(b2, _WIDTH)
    w3, b3 = _pad_to(w3, _WIDTH, C3P), _pad_to(b3, C3P)
    for name, t in (('y', y), ('o', o), ('w2', w2), ('w3', w3)):
        if t.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be 16-byte aligned')
    out = torch.empty((T, M, C3), dtype=y.dtype, device=dev)
    if T == 0 or M == 0:
        return out
    rows = torch.empty((T * M, _ROWS), dtype=torch.int32, device=dev)
    counts = torch.empty((2 * T * M + 1,), dtype=torch.int32, device=dev)  # and their prefix
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            *(a.data_ptr() for a in (y, o, idx, *starts, w2, b2, w3, b3, out, rows, counts)),
            T, N, M, S, C3, C3P, *extra, stream)
    cuda_build.check(lib, err, f'{what} launch')
    wrapper.launches += 1
    _count_rows('fwd', counts, T * M, S)
    return out


def fused_point_mlp_max_kernel(y, o, idx, w2, b2, w3, b3):
    """Launch kernel B (``csrc/sa_fused.cu``: dedupe, scan and the main
    kernel on the distinct rows) on the current stream. All tensors on one
    CUDA device, float32 (idx int64), shapes as in the plain version;
    S <= 64, C1 and C2 <= 128 (``check_rows_takes``). Raises on anything the
    kernel does not take."""
    what = 'fused_point_mlp_max_kernel'
    dims = _check_args(what, y=y, o=o, idx=idx, w2=w2, b2=b2, w3=w3, b3=b3)
    check_rows_takes(what, *dims[:2], *dims[3:6])
    return _launch_rows(fused_point_mlp_max_kernel, 'epnet_sa_fused_fwd_launch', dims,
                        (y, o, idx, w2, b2, w3, b3))


fused_point_mlp_max_kernel.launches = 0


def fused_point_mlp_max_bf16_kernel(y, o, idx, w2, b2, w3, b3):
    """Launch B-bf16 (``csrc/sa_fused.cu``: kernel B's dedupe and scan, then
    the bf16 ``wgmma`` kernel on the distinct rows) on the current stream:
    ``y``, ``o``, ``w2`` and ``w3`` bf16, ``b2`` and ``b3`` float32, idx
    int64, on one CUDA device; S <= 64, C1 and C2 <= 128, C3 <= 256
    (``check_bf16_takes``); returns (T, M, C3) bf16. Raises on anything the
    kernel does not take."""
    what = 'fused_point_mlp_max_bf16_kernel'
    dims = _check_args(what, torch.bfloat16, y=y, o=o, idx=idx, w2=w2, b2=b2, w3=w3, b3=b3)
    check_bf16_takes(what, *dims[:2], *dims[3:])
    return _launch_rows(fused_point_mlp_max_bf16_kernel, 'epnet_sa_fused_fwd_bf16_launch', dims,
                        (y, o, idx, w2, b2, w3, b3))


fused_point_mlp_max_bf16_kernel.launches = 0


def fused_point_mlp_max_bwd_kernel(y, o, idx, w2, b2, w3, b3, gout, selections=False):
    """Launch ``csrc/sa_fused_bwd.cu`` (dedupe, main kernel and the
    fixed-order reduction of the per-block dW/db slices) on the current
    stream. Tensors as in ``fused_point_mlp_max_bwd_plain``, on one CUDA
    device; S <= 64, C1 and C2 <= 128, C3 <= 256. Returns (dy, do, dw2,
    db2, dw3, db3), and with ``selections`` also the kernel's max
    selections (T, M, C3) int32: the first tied table row * 128 + the tied
    samples, -1 where no row has p3 > 0. Raises on anything the kernel does
    not take."""
    dims = _check_args('fused_point_mlp_max_bwd_kernel', y=y, o=o, idx=idx, w2=w2, b2=b2,
                       w3=w3, b3=b3, gout=gout)
    return _launch_bwd(fused_point_mlp_max_bwd_kernel, 'epnet_sa_fused_bwd_launch', dims,
                       (y, o, idx, w2, b2, w3, b3, gout), (), selections)


fused_point_mlp_max_bwd_kernel.launches = 0


def fused_point_mlp_max_bwd_bf16_kernel(y, o, idx, w2, b2, w3, b3, gout, selections=False):
    """Launch C-bf16 (``csrc/sa_fused_bwd.cu``: kernel C's dedupe and scan,
    then the bf16 ``wgmma`` kernel with certified maxima and masks) on the
    current stream: ``y``, ``o``, ``w2`` and ``w3`` bf16, ``b2``, ``b3`` and
    ``gout`` float32, idx int64, on one CUDA device; kernel C's limits.
    Returns the f32 sums (dy, do, dw2, db2, dw3, db3) of
    ``fused_point_mlp_max_bwd_plain``'s bf16 function; with ``selections``
    also the kernel's diagnostics: the selections, as kernel C, and a (2,)
    int64 tensor, the h2 elements and the maxima whose certificate failed,
    each then summed exactly. Raises on anything the kernel does not
    take."""
    dims = _check_args('fused_point_mlp_max_bwd_bf16_kernel', torch.bfloat16, y=y, o=o, idx=idx,
                       w2=w2, b2=b2, w3=w3, b3=b3, gout=gout)
    return _launch_bwd(fused_point_mlp_max_bwd_bf16_kernel, 'epnet_sa_fused_bwd_bf16_launch',
                       dims, (y, o, idx, w2, b2, w3, b3, gout), (), selections)


fused_point_mlp_max_bwd_bf16_kernel.launches = 0


def check_bwd_takes(what, T, N, S, C1, C2, C3):
    """Raise unless kernels C and H take these shapes: those of
    ``check_rows_takes`` and C3 <= 256. The differentiable entry points
    check it in a forward that records a graph on the card, so a
    configuration the backward cannot take fails there, not in its first
    backward."""
    check_rows_takes(what, T, N, S, C1, C2)
    if C3 > 2 * _WIDTH:
        raise ValueError(f'{what}: the kernel takes C3 <= {2 * _WIDTH}, got {C3}')


def _check_bwd_if_recorded(what, tensors, y, idx, w2, w3):
    """``check_bwd_takes`` when this forward records a graph on the card."""
    if y.is_cuda and torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        check_bwd_takes(what, y.shape[0], y.shape[1], idx.shape[-1], y.shape[-1],
                        w2.shape[-1], w3.shape[-1])


def _pad_to(t, *widths):
    """``t`` zero-padded at the end of its last len(widths) dims to ``widths``
    (itself when it has them already)."""
    pad = []
    for have, want in zip(reversed(t.shape[-len(widths):]), reversed(widths)):
        pad += [0, want - have]
    return torch.nn.functional.pad(t, pad) if any(pad) else t


def _launch_bwd(wrapper, entry, dims, inputs, extra, selections):
    """Kernel C, H, C-bf16 or H-bf16 (C entry point ``entry``) for
    ``wrapper``, whose launch count it keeps: pads the channels to the
    kernel's widths with zeros (which changes no gradient), allocates the
    outputs and scratch, launches, returns (dy, do, dw2, db2, dw3, db3) at
    the given widths (and, with ``selections``, the selections and the
    bf16 kernels' flagged counts). ``extra`` are the ints the entry point
    takes after c3 (H's nb, window). The f32 kernels stream W2, W3 and
    their transposes; the bf16 ones read W2 and W3 both ways from shared
    memory."""
    what = wrapper.__name__
    T, N, M, S, C1, C2, C3 = dims
    check_bwd_takes(what, T, N, S, C1, C2, C3)
    C3P = _WIDTH if C3 <= _WIDTH else 2 * _WIDTH
    lib = _bwd_lib()
    dev = inputs[0].device
    # inputs: y, o, idx[, starts], w2, b2, w3, b3, gout
    y, o, idx, w2, b2, w3, b3, gout = [t.detach().contiguous()
                                       for t in inputs[:3] + inputs[-5:]]
    starts = (inputs[3].detach().contiguous(),) if extra else ()
    y, o = _pad_to(y, _WIDTH), _pad_to(o, _WIDTH)
    w2, b2 = _pad_to(w2, _WIDTH, _WIDTH), _pad_to(b2, _WIDTH)
    w3, b3, gout = _pad_to(w3, _WIDTH, C3P), _pad_to(b3, C3P), _pad_to(gout, C3P)
    bf16 = y.dtype == torch.bfloat16
    aligned = {'y': y, 'o': o, 'w2': w2, 'w3': w3}
    if bf16:
        weights = (w2, b2, w3, b3)
    else:
        aligned.update(w2t=w2.t().contiguous(), w3t=w3.t().contiguous())
        weights = (w2, aligned['w2t'], b2, w3, aligned['w3t'], b3)
    for name, t in aligned.items():
        if t.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be 16-byte aligned')
    cents = T * M
    blocks = max(1, min(cents, torch.cuda.get_device_properties(dev).multi_processor_count))
    size = lib.epnet_sa_fused_bwd_partial_floats(C3P)
    dy = torch.zeros((T, N, _WIDTH), dtype=torch.float32, device=dev)
    do = torch.empty((T, M, _WIDTH), dtype=torch.float32, device=dev)
    rows = torch.empty((max(cents, 1), _ROWS), dtype=torch.int32, device=dev)
    # the counts and their prefix (bf16: and the tiles' records)
    counts = torch.empty((lib.epnet_sa_fused_bwd_counts_ints(cents, int(bf16)),),
                         dtype=torch.int32, device=dev)
    part = torch.empty((blocks, size), dtype=torch.float32, device=dev)
    grads = torch.empty((size,), dtype=torch.float32, device=dev)
    sel = torch.empty((T, M, C3P), dtype=torch.int32, device=dev) if selections else None
    stats = torch.zeros((2,), dtype=torch.int64, device=dev) if selections and bf16 else None
    args = (y, o, idx, *starts, *weights, gout)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            *(a.data_ptr() for a in args), dy.data_ptr(), do.data_ptr(), rows.data_ptr(),
            counts.data_ptr(), part.data_ptr(), grads.data_ptr(),
            sel.data_ptr() if selections else None,
            *((stats.data_ptr() if selections else None,) if bf16 else ()),
            T, N, M, S, C3P, *extra, blocks, stream)
    cuda_build.check(lib, err, f'{what} launch')
    wrapper.launches += 1
    _count_rows('bwd', counts, cents, S)
    dw2, db2, dw3, db3 = torch.split(grads, [_WIDTH * _WIDTH, _WIDTH, _WIDTH * C3P, C3P])
    out = (dy[..., :C1], do[..., :C1], dw2.view(_WIDTH, _WIDTH)[:C1, :C2], db2[:C2],
           dw3.view(_WIDTH, C3P)[:C2, :C3], db3[:C3])
    return out + ((sel[..., :C3],) if selections else ()) + ((stats,) if stats is not None else ())


class _FusedPointMlpMax(torch.autograd.Function):
    """Forward and backward by kernel on CUDA, by plain version on the CPU;
    saves only the inputs."""

    @staticmethod
    def forward(ctx, y, o, idx, w2, b2, w3, b3):
        ctx.save_for_backward(y, o, idx, w2, b2, w3, b3)
        if y.is_cuda:
            kernel = (fused_point_mlp_max_bf16_kernel if y.dtype == torch.bfloat16
                      else fused_point_mlp_max_kernel)
            return kernel(y, o, idx, w2, b2, w3, b3)
        return fused_point_mlp_max_plain(y, o, idx, w2, b2, w3, b3)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        y, o, idx, w2, b2, w3, b3 = args = ctx.saved_tensors
        gout = gout.float()
        if gout.is_cuda:
            kernel = (fused_point_mlp_max_bwd_bf16_kernel if y.dtype == torch.bfloat16
                      else fused_point_mlp_max_bwd_kernel)
            grads = kernel(*args, gout)
        else:
            grads = fused_point_mlp_max_bwd_plain(*args, gout)
        dy, do, dw2, db2, dw3, db3 = cast_grads(grads, y, o, w2, b2, w3, b3)
        return dy, do, None, dw2, db2, dw3, db3


def fused_point_mlp_max(y, o, idx, w2, b2, w3, b3):
    """(T, M, C3) fused SA interior, differentiable in every input but
    ``idx``: the CUDA kernels for CUDA tensors, the plain versions for CPU
    tensors. f32, or bf16 ``y``, ``o``, ``w2``, ``w3`` with f32 biases
    (B-bf16 and C-bf16 on the card)."""
    if y.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'fused_point_mlp_max: unsupported device {y.device}')
    _check_bwd_if_recorded('fused_point_mlp_max', (y, o, w2, b2, w3, b3), y, idx, w2, w3)
    return _FusedPointMlpMax.apply(y, o, idx, w2, b2, w3, b3)


# ---------------------------------------------------------------------------
# Windowed form (kernels G and H): the rows of centroid m come from the
# window of ``window`` table rows starting at starts[t, m // (M // NB)].
# ---------------------------------------------------------------------------


def window_rows(idx_rel, starts):
    """Table rows of window-relative indices: idx_rel (T, M, S) + the start
    of each centroid's tile, starts (T, NB) with NB dividing M."""
    M, NB = idx_rel.shape[1], starts.shape[1]
    return idx_rel + starts.repeat_interleave(M // NB, dim=1)[..., None]


def fused_point_mlp_max_win_plain(y, o, idx_rel, starts, w2, b2, w3, b3, window):
    """``fused_point_mlp_max_plain`` on the rows ``window_rows(idx_rel,
    starts)``; idx_rel (T, M, S) int64 in [0, window), starts (T, NB)
    int64."""
    return fused_point_mlp_max_plain(y, o, window_rows(idx_rel, starts), w2, b2, w3, b3)


def fused_point_mlp_max_win_bwd_plain(y, o, idx_rel, starts, w2, b2, w3, b3, window, gout):
    """Gradients of ``fused_point_mlp_max_win_plain`` (the f32 sums, in bf16
    H-bf16's function, as ``fused_point_mlp_max_bwd_plain``): the windows of
    one table's tiles overlap, and dy adds up every tile's rows."""
    return fused_point_mlp_max_bwd_plain(y, o, window_rows(idx_rel, starts), w2, b2, w3, b3,
                                         gout)


def fused_point_mlp_max_win_kernel(y, o, idx_rel, starts, w2, b2, w3, b3, window):
    """Launch kernel G (``csrc/sa_fused.cu``: the windowed dedupe, then
    kernel B's scan and main kernel on the distinct rows) on the current
    stream. Tensors as in the plain version, on one CUDA device, float32
    (idx_rel and starts int64); kernel B's limits (``check_rows_takes``).
    Raises on anything the kernel does not take."""
    what = 'fused_point_mlp_max_win_kernel'
    dims = _check_args(what, y=y, o=o, idx=idx_rel, starts=starts, w2=w2, b2=b2, w3=w3, b3=b3)
    NB = _check_window(what, starts, window, *dims[:3])
    check_rows_takes(what, *dims[:2], *dims[3:6])
    return _launch_rows(fused_point_mlp_max_win_kernel, 'epnet_sa_fused_win_fwd_launch', dims,
                        (y, o, idx_rel, starts, w2, b2, w3, b3), (NB, window))


fused_point_mlp_max_win_kernel.launches = 0


def fused_point_mlp_max_win_bf16_kernel(y, o, idx_rel, starts, w2, b2, w3, b3, window):
    """Launch G-bf16 (``csrc/sa_fused.cu``: the windowed dedupe, then
    B-bf16's kernel on the distinct rows) on the current stream: tensors as
    for ``fused_point_mlp_max_win_kernel`` but ``y``, ``o``, ``w2`` and
    ``w3`` bf16, and B-bf16's limits (``check_bf16_takes``); returns bf16.
    Raises on anything the kernel does not take."""
    what = 'fused_point_mlp_max_win_bf16_kernel'
    dims = _check_args(what, torch.bfloat16, y=y, o=o, idx=idx_rel, starts=starts, w2=w2, b2=b2,
                       w3=w3, b3=b3)
    NB = _check_window(what, starts, window, *dims[:3])
    check_bf16_takes(what, *dims[:2], *dims[3:])
    return _launch_rows(fused_point_mlp_max_win_bf16_kernel,
                        'epnet_sa_fused_win_fwd_bf16_launch', dims,
                        (y, o, idx_rel, starts, w2, b2, w3, b3), (NB, window))


fused_point_mlp_max_win_bf16_kernel.launches = 0


def fused_point_mlp_max_win_bwd_kernel(y, o, idx_rel, starts, w2, b2, w3, b3, window, gout,
                                       selections=False):
    """Launch kernel H (``csrc/sa_fused_bwd.cu``, windowed) and its
    reduction on the current stream. Tensors as in
    ``fused_point_mlp_max_win_bwd_plain``; S <= 64. Returns (dy, do, dw2,
    db2, dw3, db3) (and the selections, as for kernel C). Raises on
    anything the kernel does not take."""
    what = 'fused_point_mlp_max_win_bwd_kernel'
    dims = _check_args(what, y=y, o=o, idx=idx_rel, starts=starts, w2=w2, b2=b2, w3=w3, b3=b3,
                       gout=gout)
    NB = _check_window(what, starts, window, *dims[:3])
    return _launch_bwd(fused_point_mlp_max_win_bwd_kernel, 'epnet_sa_fused_win_bwd_launch', dims,
                       (y, o, idx_rel, starts, w2, b2, w3, b3, gout), (NB, window), selections)


fused_point_mlp_max_win_bwd_kernel.launches = 0


def fused_point_mlp_max_win_bwd_bf16_kernel(y, o, idx_rel, starts, w2, b2, w3, b3, window, gout,
                                            selections=False):
    """Launch H-bf16 (``csrc/sa_fused_bwd.cu``: the windowed dedupe, then
    C-bf16's kernel) on the current stream: tensors as for
    ``fused_point_mlp_max_win_bwd_kernel`` with ``y``, ``o``, ``w2`` and
    ``w3`` bf16; returns the f32 sums (and, with ``selections``, the
    selections and the flagged counts), as C-bf16. Raises on anything the
    kernel does not take."""
    what = 'fused_point_mlp_max_win_bwd_bf16_kernel'
    dims = _check_args(what, torch.bfloat16, y=y, o=o, idx=idx_rel, starts=starts, w2=w2, b2=b2,
                       w3=w3, b3=b3, gout=gout)
    NB = _check_window(what, starts, window, *dims[:3])
    return _launch_bwd(fused_point_mlp_max_win_bwd_bf16_kernel,
                       'epnet_sa_fused_win_bwd_bf16_launch', dims,
                       (y, o, idx_rel, starts, w2, b2, w3, b3, gout), (NB, window), selections)


fused_point_mlp_max_win_bwd_bf16_kernel.launches = 0


def wgmma_sum_probe(a, w):
    """(sums, gamma_tc): the (T, 64, 64) f32 sums a @ w of bf16 a (T, 64,
    128) and w (128, 64) on the card, summed as C-bf16's recompute sums p2
    (``csrc/sa_fused_bwd.cu``, ``sa_wgmma_sum_probe``), and the gamma_tc
    with which the kernel's certificate bounds their error (its
    ``kGammaTc``): the probe of the tensor cores' accumulation. Not a path
    of the model."""
    if not (a.is_cuda and w.is_cuda and a.dtype == w.dtype == torch.bfloat16
            and a.dim() == 3 and a.shape[1:] == (_ROWS, _WIDTH) and w.shape == (_WIDTH, 64)):
        raise ValueError('wgmma_sum_probe: bf16 CUDA a (T, 64, 128) and w (128, 64)')
    lib = _bwd_lib()
    a, w = a.contiguous(), w.contiguous()
    out = torch.empty((a.shape[0], _ROWS, 64), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.epnet_sa_wgmma_sum_probe(a.data_ptr(), w.data_ptr(), out.data_ptr(), a.shape[0],
                                           torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check(lib, err, 'wgmma_sum_probe launch')
    return out, lib.epnet_sa_fused_bwd_bf16_gamma(0)


class _FusedPointMlpMaxWin(torch.autograd.Function):
    """Kernels G and H on CUDA, plain versions on the CPU; saves only the
    inputs."""

    @staticmethod
    def forward(ctx, y, o, idx_rel, starts, w2, b2, w3, b3, window):
        ctx.save_for_backward(y, o, idx_rel, starts, w2, b2, w3, b3)
        ctx.window = window
        if y.is_cuda:
            kernel = (fused_point_mlp_max_win_bf16_kernel if y.dtype == torch.bfloat16
                      else fused_point_mlp_max_win_kernel)
            return kernel(y, o, idx_rel, starts, w2, b2, w3, b3, window)
        return fused_point_mlp_max_win_plain(y, o, idx_rel, starts, w2, b2, w3, b3, window)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        y, o, idx_rel, starts, w2, b2, w3, b3 = args = ctx.saved_tensors
        if not gout.is_cuda:
            bwd = fused_point_mlp_max_win_bwd_plain
        elif y.dtype == torch.bfloat16:
            bwd = fused_point_mlp_max_win_bwd_bf16_kernel
        else:
            bwd = fused_point_mlp_max_win_bwd_kernel
        grads = bwd(*args, ctx.window, gout.float())
        dy, do, dw2, db2, dw3, db3 = cast_grads(grads, y, o, w2, b2, w3, b3)
        return dy, do, None, None, dw2, db2, dw3, db3, None


def fused_point_mlp_max_win(y, o, idx_rel, starts, w2, b2, w3, b3, window: int):
    """(T, M, C3) fused SA interior with each tile's rows read from its
    window, differentiable in every input but ``idx_rel`` and ``starts``:
    kernels G and H for CUDA tensors, the plain versions for CPU tensors.

    :param idx_rel: (T, M, S) int64 window-relative rows in [0, window)
    :param starts: (T, NB) int64 first table row of each tile's window; the
        tile of centroid m is m // (M // NB)

    f32, or bf16 ``y``, ``o``, ``w2``, ``w3`` with f32 biases (G-bf16 and
    H-bf16 on the card).
    """
    if y.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'fused_point_mlp_max_win: unsupported device {y.device}')
    _check_bwd_if_recorded('fused_point_mlp_max_win', (y, o, w2, b2, w3, b3), y, idx_rel, w2,
                           w3)
    return _FusedPointMlpMaxWin.apply(y, o, idx_rel, starts, w2, b2, w3, b3, window)
