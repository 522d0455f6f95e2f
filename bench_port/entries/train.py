"""The train entry: train steps back to back through
``epnet_tpu_torch.train.trainer.train_step`` on
``create_train_state(cfg, total_steps)``, at a fixed BN momentum, rotating
``distinct_batches`` labelled batches; each step's loss is read to the
host, as the Trainer logs it.

Set-up takes the first ``followed_steps`` steps on distinct batches
through the same call and records what the comparison needs: each step's
loss, its RPN outputs, the RoIs, their scores and the seg mask that the
proposal layer made of them, the first step's gradient from the
optimizer's first moment, and the parameters' change over the steps.

The traffic keys it reads are ``KEYS``; ``harness.cell`` refuses a mix
that sets any other.
"""

from __future__ import annotations

import statistics

import torch

from bench_port import harness, judge, scenes, spans

KEYS = {'batch', 'distinct_batches', 'scenes_seed', 'bn_momentum', 'total_steps',
        'followed_steps', 'stage_requests', 'profile_steps'}
RECORDED = {'rpn_cls': 'rpn_cls', 'rpn_reg': 'rpn_reg', 'xyz': 'backbone_xyz', 'rois': 'rois',
            'roi_scores': 'roi_scores_raw', 'seg': 'seg_result'}


class Entry:
    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        from epnet_tpu_torch.config import Config
        from epnet_tpu_torch.train.trainer import create_train_state, train_step

        tree = cfg_file['model']
        self.cfg_file, self.traffic, self.seed, self.device = cfg_file, traffic, seed, device
        self.cfg = Config().merged(tree)
        self.state = create_train_state(self.cfg, traffic['total_steps'], device=device)
        self.state.model.load_state_dict(judge.benchmark_weights(cfg_file, seed, device))
        self.train_step = train_step
        self.bn_momentum = traffic['bn_momentum']
        self.generator = torch.Generator(device=device).manual_seed(harness.generator_seed(seed))
        self.batches = scenes.make_batches(tree, traffic['batch'], traffic['distinct_batches'],
                                           traffic['scenes_seed'], seed, device, with_labels=True,
                                           img_hw=tuple(cfg_file['image_hw']))
        model = self.state.model
        names = {id(p): n for n, p in model.named_parameters()}
        params = self.state.optimizer.params
        start = [p.detach().clone() for p in params]
        n = traffic['followed_steps']
        rec = {'batches': self.batches[:n], 'loss': [], 'total_steps': traffic['total_steps'],
               'generator_seed': harness.generator_seed(seed), 'bn_momentum': self.bn_momentum}
        rec.update({k: [] for k in RECORDED})

        def keep(module, args, out):
            for k, o in RECORDED.items():
                rec[k].append(out[o].detach().clone())

        hook = model.register_forward_hook(keep)
        self.turn = 0
        for k in range(n):
            rec['loss'].append(self.step(self.next_batch()))
            if k == 0:
                b1 = self._beta1_at_start()
                rec['grad1'] = {names[id(p)]: m / (1.0 - b1) for p, m in
                                zip(params, self.state.optimizer.state_dict()['mu'])}
        hook.remove()
        rec['delta'] = {names[id(p)]: p.detach() - p0 for p, p0 in zip(params, start)}
        self.record = rec
        for b in self.batches[n:]:  # every batch the traffic uses
            self.step(self.next_batch())

    def _beta1_at_start(self) -> float:
        from bench_port.reference import train as ref_train

        t = self.cfg_file['model']['TRAIN']
        return ref_train.one_cycle(self.traffic['total_steps'], t['PCT_START'],
                                   (t['MOMS'][0], t['MOMS'][1]), (t['MOMS'][1], t['MOMS'][0]))(0)

    def step(self, batch) -> float:
        tb = self.train_step(self.state, batch, self.bn_momentum, self.generator)
        return float(tb['loss'])

    def next_batch(self):
        b = self.batches[self.turn % len(self.batches)]
        self.turn += 1
        return b

    def window(self, seconds: float) -> dict:
        return harness.closed_loop(lambda i: self.step(self.next_batch()), seconds,
                                   self.traffic['batch'], self.device)

    def stage_ms(self) -> dict:
        per = [spans.train_stage_ms(self.state, self.next_batch(), self.bn_momentum,
                                    self.generator)
               for _ in range(self.traffic['stage_requests'])]
        return {k: statistics.median(p[k] for p in per) for k in per[0]}

    def profile(self, trace_path) -> dict:
        return spans.profile(lambda: self.step(self.next_batch()), self.traffic['profile_steps'],
                             trace_path)

    def free(self) -> None:
        self.state = None

    def judge(self) -> dict:
        return judge.judge_train(self.cfg_file, self.seed, self.device, self.record)
