"""The eval entry: a closed loop of one caller. Batches of ``batch`` scans
go back to back through ``epnet_tpu_torch.eval.detect.joint_eval_step`` on
``EPNet(cfg, 'TEST')``, rotating ``distinct_batches`` batches; a request
ends when its detections (``final_*``) are on the host, and the next is
sent then.

The traffic keys it reads are ``KEYS``; ``harness.cell`` refuses a mix
that sets any other, so a mix that wants another loop (open, or several
callers) names an entry file of its own.
"""

from __future__ import annotations

import statistics

from bench_port import harness, judge, scenes, spans

KEYS = {'batch', 'distinct_batches', 'scenes_seed', 'sample_from', 'check_requests',
        'stage_requests', 'profile_steps'}
FINAL_KEYS = ('final_boxes', 'final_scores', 'final_counts')


class Entry:
    """Builds the program with the benchmark's weights and scenes and warms
    up every shape the traffic uses; ``window`` runs the loop and keeps the
    requests that the comparison samples."""

    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        from epnet_tpu_torch.config import Config
        from epnet_tpu_torch.eval.detect import joint_eval_step
        from epnet_tpu_torch.models.epnet import EPNet

        tree = cfg_file['model']
        self.cfg_file, self.traffic, self.seed, self.device = cfg_file, traffic, seed, device
        self.cfg = Config().merged(tree)
        self.model = EPNet(self.cfg, 'TEST', device=device).eval()
        self.model.load_state_dict(judge.benchmark_weights(cfg_file, seed, device))
        self.joint_eval_step = joint_eval_step
        self.last_out = None
        self.model.register_forward_hook(self._keep)
        self.batches = scenes.make_batches(tree, traffic['batch'], traffic['distinct_batches'],
                                           traffic['scenes_seed'], seed, device,
                                           img_hw=tuple(cfg_file['image_hw']))
        self.samples = []
        self.turn = 0
        for b in self.batches + self.batches[:1]:  # every shape the traffic uses
            self.request(b)

    def _keep(self, module, args, output):
        self.last_out = output

    def request(self, batch):
        res = self.joint_eval_step(self.cfg, self.model, batch)
        return res, {k: res[k].cpu() for k in FINAL_KEYS}

    def next_batch(self):
        b = self.batches[self.turn % len(self.batches)]
        self.turn += 1
        return b

    def window(self, seconds: float) -> dict:
        keep = set(harness.sample_ids(self.seed, self.traffic))
        self.turn = 0

        def one(i):
            batch = self.next_batch()
            res, host = self.request(batch)
            if i in keep:
                self.samples.append((batch, self.last_out,
                                     {'pred_boxes3d': res['pred_boxes3d'], **host}))

        return harness.closed_loop(one, seconds, self.traffic['batch'], self.device)

    def stage_ms(self) -> dict:
        per = [spans.eval_stage_ms(self.model, self.next_batch())
               for _ in range(self.traffic['stage_requests'])]
        return {k: statistics.median(p[k] for p in per) for k in per[0]}

    def profile(self, trace_path) -> dict:
        return spans.profile(lambda: self.request(self.next_batch()),
                             self.traffic['profile_steps'], trace_path)

    def free(self) -> None:
        self.model = self.last_out = None

    def judge(self) -> dict:
        return judge.judge_eval(self.cfg_file, self.seed, self.device, self.samples)
