"""The rank side of ``test_torch_data_parallel.py``: functions that
``parallel.mesh.run_ranks`` runs on each spawned rank, as
``fn(mesh, *args)``. This module imports no JAX, so a rank starts in the
time torch and the port take to import; each function returns plain
tensors, which the test holds against the one-process run."""

import contextlib

import numpy as np
import torch

from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models.fusion import DeconvBnReluSample
from epnet_tpu_torch.models.target_assign import RCNNTargets
from epnet_tpu_torch.parallel.mesh import all_sum, batch_sum, rank_rows, shard_batch, world_of
from epnet_tpu_torch.train.trainer import Trainer, create_train_state, train_step


def global_mean(mesh):
    """A global (8, 16) batch whose row i holds i; each rank holds its 4
    rows (``shard_batch``) and the mean is the global batch's."""
    x = np.arange(8, dtype=np.float32)[:, None] + np.zeros((1, 16), np.float32)
    local = torch.from_numpy(shard_batch(mesh, {'x': x})['x'])
    return {'rows': local[:, 0].tolist(),
            'mean': float(batch_sum(mesh, local.sum()) / (8 * 16))}


def near_gt_layer(real):
    """``proposal_target_layer`` with each image's first RoIs replaced by
    its gt boxes moved 0.15 m and grown 5% (where the gt is real), so that
    a freshly initialized model's RCNN sees foreground RoIs."""

    def layer(rois, gt_boxes3d, *args, **kwargs):
        gt = gt_boxes3d[..., :7]
        near = torch.cat([gt[..., 0:1] + 0.15, gt[..., 1:3], gt[..., 3:6] * 1.05, gt[..., 6:]],
                         -1)
        k = min(gt.shape[1], rois.shape[1])
        rois = rois.clone()
        rois[:, :k] = torch.where((gt[:, :k] != 0).any(-1, keepdim=True), near[:, :k],
                                  rois[:, :k])
        return real(rois, gt_boxes3d, *args, **kwargs)

    return layer


@contextlib.contextmanager
def target_layer(layer):
    real = tep.proposal_target_layer
    tep.proposal_target_layer = layer
    try:
        yield
    finally:
        tep.proposal_target_layer = real


def fixed_targets(mesh, targets):
    """A target layer returning the rank's rows of the global batch's
    ``targets`` (a dict of RCNNTargets' fields)."""
    n = targets['cls_label'].shape[0] // world_of(mesh)

    def layer(*args, **kwargs):
        return RCNNTargets(**{k: rank_rows(mesh, v, n) for k, v in targets.items()})

    return layer


def step_results(state, tb):
    model = state.model
    out = {'tb': {k: float(v) for k, v in tb.items()},
           'grads': {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None},
           'params': {n: p.detach().clone() for n, p in model.named_parameters()},
           'stats': {k: v.clone() for k, v in model.state_dict().items()
                     if k.endswith(('running_mean', 'running_var'))},
           'lr': state.optimizer.lr(state.optimizer.count - 1)}
    return out


def train_case(mesh, cfg, batch, init=None, targets=None, seed=0, total_steps=100):
    """One step on the rank's rows of the global ``batch`` (numpy) from
    ``init`` (a state dict; the port's own init from ``seed`` when None),
    dropout and RoI draws from a generator seeded 7; the target layer is
    the near-gt one, or returns the rank's rows of ``targets``. Returns
    the step's results, the parameters before it, the targets the rank's
    RCNN saw and, under a mesh, the step's all-reduces."""
    state = create_train_state(cfg, total_steps, device='cpu',
                               generator=torch.Generator().manual_seed(seed))
    if init is not None:
        state.model.load_state_dict(init)
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    local = {k: torch.from_numpy(v) for k, v in shard_batch(mesh, batch).items()}
    real = fixed_targets(mesh, targets) if targets is not None \
        else near_gt_layer(tep.proposal_target_layer)
    seen = []

    def layer(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    counts = dict(mesh.stats) if mesh is not None else None
    with target_layer(layer):
        tb = train_step(state, local, 0.1, torch.Generator().manual_seed(7), mesh)
    out = step_results(state, tb)
    out.update(before=params, targets={k: v.clone() for k, v in seen[0]._asdict().items()})
    if mesh is not None:
        out['all_reduces'] = {k: v - counts[k] for k, v in mesh.stats.items()}
    return out


def multi_step_case(mesh, cfg, batches, steps_per_call, ckpt_dir, seed=0):
    """``Trainer`` for one epoch over ``batches`` (a list of global numpy
    batches) with ``steps_per_call``: each step's loss, each K-step call's
    ``tb``, the scalars written and the parameters after."""
    state = create_train_state(cfg, 100, device='cpu',
                               generator=torch.Generator().manual_seed(seed))
    written = []

    class Scalars:
        def scalar(self, tag, value, step):
            written.append((tag, float(value), int(step)))

    trainer = Trainer(cfg, state, ckpt_dir=ckpt_dir, tb_log=Scalars(), seed=7, device='cpu',
                      mesh=mesh, steps_per_call=steps_per_call)
    local = [shard_batch(mesh, b) for b in batches]
    calls, losses = [], []
    step, dispatch = trainer._step, trainer._dispatch

    def recorded_step(batch, bnm):
        tb = step(batch, bnm)
        losses.append(float(tb['loss']))
        return tb

    def recorded_dispatch(pending, bnm):
        tb = dispatch(pending, bnm)
        calls.append({k: float(v) for k, v in tb.items()})
        return tb

    trainer._step, trainer._dispatch = recorded_step, recorded_dispatch
    with target_layer(near_gt_layer(tep.proposal_target_layer)):
        trainer.train(0, 1, local)
    return {'params': {n: p.detach().clone() for n, p in state.model.named_parameters()},
            'written': written, 'calls': calls, 'losses': losses, 'step': state.step}


def deconv_case(mesh, kernels, eps, inputs, g):
    """``DeconvBnReluSample`` on the rank's rows of the global inputs: its
    output rows, the statistics, the rows of the maps' gradients and the
    shared tensors' gradients summed over ranks."""
    n = inputs['xy'].shape[0] // world_of(mesh)
    xy = rank_rows(mesh, inputs['xy'], n)
    xs = [rank_rows(mesh, x, n).clone().requires_grad_() for x in inputs['xs']]
    shared = {k: inputs[k].clone().requires_grad_() for k in ('bias_fused', 'scale', 'bias')}
    cws = [c.clone().requires_grad_() for c in inputs['cws']]
    pts, mean, unbiased = DeconvBnReluSample.apply(
        kernels, eps, mesh, xy, shared['bias_fused'], shared['scale'], shared['bias'], *xs,
        *cws)
    pts.backward(rank_rows(mesh, g, n))
    return {'pts': pts.detach(), 'mean': mean, 'unbiased': unbiased,
            'dxs': [x.grad for x in xs],
            'dshared': {k: all_sum(mesh, v.grad) for k, v in shared.items()},
            'dcws': [all_sum(mesh, c.grad) for c in cws]}


def run_all(mesh, cases):
    """Every case of ``cases`` (name -> (function name, args)) on this rank,
    in order; their results by name."""
    return {name: globals()[fn](mesh, *args) for name, (fn, args) in cases.items()}
