"""Time the FPS kernel (A), the fused-SA forward (B, and its windowed twin
G) and backward (C, and its windowed twin H), the image tower's conv
kernels (D and E, the weight gradients; F, the stride-2 forward) and the
bf16 kernels (B-bf16, G-bf16, F-bf16; C-bf16, H-bf16, D-bf16, E-bf16) of
several checkouts of this repository on one card, in turns.

    python -m epnet_tpu_torch.tools.kernel_turns --trees <parent> . . <parent> [--out DIR]

Run from the root of this checkout. Each checkout in ``--trees`` runs in
its own process, in the order given, with its own sources and build
(``<tree>/build``), on the same inputs: those of ``chip_smoke.py``'s
phases 1 (A: the six FPS shapes of a forward, the batch-4 RPN sa0 shape,
the tie-heavy cloud), 2 (B: RCNN sa0 and sa1 on random tables, sa0 on real
eval tables; B-bf16 on the same tables in bf16) and 5 (C: the same at the
batch-4 train step's T = 256), G and H at the block-local RCNN sa0 on real
windows (G at T = 100 and 256, H at 256), G-bf16 on phase 17's real
windows, T = 100, and phases 8
and 10 (D and E at ``chip_smoke.DW_SHAPES``, F at ``chip_smoke.FWD_SHAPES``;
F-bf16 on F's inputs in bf16), and the bf16 backward kernels on the same
inputs in bf16 (C-bf16 on C's, H-bf16 on H's, D-bf16 and E-bf16 on D's and
E's; a checkout that has not these kernels skips them). A, B, B-bf16,
G-bf16, C and H's inputs are
made once, by this checkout's ``chip_smoke.py``, and saved to ``--out``
(G, G-bf16 and H through the wrappers' Python signatures, which the
checkouts share);
the conv inputs are made in each process on the card by this checkout's
``chip_smoke.dw_cases`` and ``fwd_cases``, from their seeds. Each process
checks its outputs against this checkout's plain versions (picks
identical, B and G within ``chip_smoke.SA_RTOL`` of max|out|, D and E within
``DW_RTOL`` of max|dw|, F within ``FWD_RTOL`` of max|y|, the bf16 kernels
within ``BF16_ULPS`` bf16 units of max|out|), times each case with
``chip_smoke._time_ms`` at phase 1's, 2's, 5's, 8's, 10's and 17's
repetitions (A also replayed from a CUDA graph, without the host's launch
time) and saves C's and H's six outputs, E's dw, F-bf16's y and D-bf16's
and E-bf16's dw; the last lines say whether each run's dO, dW and db, E's
dw and F-bf16's y are bitwise those of the first run (dY sums a row's
contributions by f32 atomics, in no fixed order: its largest difference is
printed; D-bf16's and E-bf16's dw, whose summation order is their
design's, print their largest difference in units of ``DW_RTOL`` of
max|dw| beside, and C-bf16's and H-bf16's dO, dW and db theirs in units of
``SA_RTOL`` of max|.|), and give a table of milliseconds, one column a
run. Comparing two versions means
running them in turns in one call: parent, change, change, parent. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_inputs(path):
    """Every case's inputs, made on the card by chip_smoke.py's input
    functions, saved."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    dev = torch.device('cuda:0')
    fps_in = [(shape, kind, xyz.cpu()) for shape, kind, xyz in cs.fps_cases(dev)]
    sa_in = [(name, [a.cpu() for a in args]) for name, _, _, args in cs.sa_cases(dev)]
    bwd_in = [(name, [a.cpu() for a in args])
              for name, _, _, args in cs.sa_cases(dev, train=True)]
    T, (_, N, M, S, C1, C2, C3) = 256, cs.SA_SHAPES['rcnn.sa0']
    rng = np.random.RandomState(13)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    idx_rel, starts = cs._window_inputs(T, T, dev)
    window = cs._sa_win_geometry()[0]
    args = (f(T, N, C1), f(T, M, C1, scale=0.1), idx_rel.cpu(), starts.cpu(),
            f(C1, C2, scale=C1 ** -0.5), f(C2, scale=0.01), f(C2, C3, scale=C2 ** -0.5),
            f(C3, scale=0.01), window, f(T, M, C3))
    T = 100
    idx_rel, starts = cs._window_inputs(T, T, dev)
    bf = torch.bfloat16
    win_bf16 = (f(T, N, C1).to(bf), f(T, M, C1, scale=0.1).to(bf), idx_rel.cpu(), starts.cpu(),
                f(C1, C2, scale=C1 ** -0.5).to(bf), f(C2, scale=0.01),
                f(C2, C3, scale=C2 ** -0.5).to(bf), f(C3, scale=0.01), window)
    win_fwd = [(256, args[:9]),
               (T, (f(T, N, C1), f(T, M, C1, scale=0.1), idx_rel.cpu(), starts.cpu(),
                    f(C1, C2, scale=C1 ** -0.5), f(C2, scale=0.01), f(C2, C3, scale=C2 ** -0.5),
                    f(C3, scale=0.01), window))]
    torch.save({'fps': fps_in, 'sa': sa_in, 'bwd': bwd_in, 'win_bwd': args,
                'win_fwd_bf16': win_bf16, 'win_fwd': win_fwd}, path)


def _graph_ms(fn, reps):
    """Mean ms of ``reps`` launches of ``fn`` captured in one CUDA graph and
    replayed: the device's time with no host time between launches, which
    a kernel of a few microseconds needs (a launch through its wrapper
    costs the host more than that)."""
    import torch

    fn()  # the launchers' once-a-device set-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def conv_worker(cs, tree, ms, outputs):
    """D, E and F of this process's checkout on phases 8's and 10's tower
    inputs, made here: checked against the plain versions, timed into
    ``ms``; E's dw into ``outputs``. ``cs``: this checkout's
    ``chip_smoke``."""
    import torch

    dev = torch.device('cuda:0')
    cs._require_f32(tree)
    for name, blk, stride, x, dy in cs.dw_cases(dev):
        if name == 'edge':
            continue
        kernel, plain = cs.dw_kernel_and_plain(stride)
        got, want = kernel(x, dy), plain(x, dy)
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= cs.DW_RTOL:
            raise AssertionError(f'{tree}: {name} off by {err:.3e} at {blk}')
        key = f'{"D" if stride == 2 else "E"} {blk}'
        if stride == 1:
            outputs[key] = got.cpu()
        del got, want
        ms[key] = cs._time_ms(lambda: kernel(x, dy), 10)
    from epnet_tpu_torch.ops import conv2d
    kernel, plain = conv2d.conv3x3_s2_fwd_kernel, conv2d.conv3x3_s2_fwd_plain
    for name, _, x, w in cs.fwd_cases(dev):
        if name == 'edge':
            continue
        want = plain(x, w)
        err = float((kernel(x, w) - want).abs().max() / want.abs().max())
        if not err <= cs.FWD_RTOL:
            raise AssertionError(f'{tree}: F off by {err:.3e} at {name}')
        del want
        ms[f'F {name}'] = cs._time_ms(lambda: kernel(x, w), 10)


def fps_sa_worker(cs, tree, saved, ms, outputs):
    """A, B, G, C and H of this process's checkout on the saved inputs:
    checked against the plain versions, timed into ``ms``; C's and H's
    gradients into ``outputs``."""
    import torch
    from epnet_tpu_torch.ops import fps, sa_fused

    dev = torch.device('cuda:0')
    for (B, N, npoint), kind, xyz in saved['fps']:
        xyz = xyz.to(dev)
        if not torch.equal(fps.furthest_point_sample_kernel(xyz, npoint),
                           fps.furthest_point_sample_plain(xyz, npoint)):
            raise AssertionError(f'{tree}: fps picks differ from plain at {(B, N, npoint)}')

        def launch():
            return fps.furthest_point_sample_kernel(xyz, npoint)
        reps = 10 if N > 1024 else 200
        ms[f'A {B}x{N}->{npoint} {kind}'] = cs._time_ms(launch, reps)
        ms[f'A {B}x{N}->{npoint} {kind}, graph'] = _graph_ms(launch, reps)
    for name, args in saved['sa']:
        args = [a.to(dev) for a in args]
        want = sa_fused.fused_point_mlp_max_plain(*args)
        err = float((sa_fused.fused_point_mlp_max_kernel(*args) - want).abs().max()
                    / want.abs().max())
        if not err <= cs.SA_RTOL:
            raise AssertionError(f'{tree}: fused SA off by {err:.3e} at {name}')
        ms[f'B {name}'] = cs._time_ms(lambda: sa_fused.fused_point_mlp_max_kernel(*args), 20)
    for T, args in saved['win_fwd']:
        args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        want = sa_fused.fused_point_mlp_max_win_plain(*args)
        err = float((sa_fused.fused_point_mlp_max_win_kernel(*args) - want).abs().max()
                    / want.abs().max())
        if not err <= cs.SA_RTOL:
            raise AssertionError(f'{tree}: G off by {err:.3e} at T={T}')
        del want
        ms[f'G rcnn.sa0 real windows T={T}'] = cs._time_ms(
            lambda: sa_fused.fused_point_mlp_max_win_kernel(*args), 20)
    bwd = [(f'C {name} T=256', sa_fused.fused_point_mlp_max_bwd_kernel, args)
           for name, args in saved['bwd']]
    bwd.append(('H rcnn.sa0 T=256', sa_fused.fused_point_mlp_max_win_bwd_kernel,
                saved['win_bwd']))
    for name, fn, args in bwd:
        args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        outputs[name] = [g.cpu() for g in fn(*args)]
        ms[name] = cs._time_ms(lambda: fn(*args), 5)


def bf16_worker(cs, tree, saved, ms, outputs):
    """B-bf16 (the saved B inputs in bf16), G-bf16 (the saved real windows)
    and F-bf16 (phase 10's inputs, made here, in bf16) of this process's
    checkout: checked against the plain versions, timed into ``ms``;
    F-bf16's y into ``outputs``."""
    import torch
    from epnet_tpu_torch.ops import conv2d, sa_fused

    dev = torch.device('cuda:0')
    bf = torch.bfloat16

    def checked(name, fn, plain, args):
        got, want = fn(*args), plain(*args)
        err = float((got.float() - want.float()).abs().max())
        ulp = cs._bf16_ulp(float(want.float().abs().max()))
        if not err <= cs.BF16_ULPS * ulp:
            raise AssertionError(f'{tree}: {name} off by {err:.3e}, one bf16 ulp {ulp:.3e}')
        return got

    kernel, plain = sa_fused.fused_point_mlp_max_bf16_kernel, sa_fused.fused_point_mlp_max_plain
    for name, args in saved['sa']:
        args = [a.to(dev, bf) if i in (0, 1, 3, 5) else a.to(dev) for i, a in enumerate(args)]
        checked(f'B-bf16 {name}', kernel, plain, args)
        ms[f'B-bf16 {name}'] = cs._time_ms(lambda: kernel(*args), 20)
    kernel = sa_fused.fused_point_mlp_max_win_bf16_kernel
    args = [a.to(dev) if torch.is_tensor(a) else a for a in saved['win_fwd_bf16']]
    checked('G-bf16', kernel, sa_fused.fused_point_mlp_max_win_plain, args)
    ms['G-bf16 rcnn.sa0 real windows T=100'] = cs._time_ms(lambda: kernel(*args), 20)
    kernel, plain = conv2d.conv3x3_s2_fwd_bf16_kernel, conv2d.conv3x3_s2_fwd_plain
    for name, _, x, w in cs.fwd_cases(dev):
        if name == 'edge':
            continue
        x, w = x.to(bf), w.to(bf)
        outputs[f'F-bf16 {name}'] = checked(f'F-bf16 {name}', kernel, plain, (x, w)).cpu()
        ms[f'F-bf16 {name}'] = cs._time_ms(lambda: kernel(x, w), 10)


def bf16_bwd_worker(cs, tree, saved, ms, outputs):
    """C-bf16 and H-bf16 (the saved C and H inputs in bf16), D-bf16 and
    E-bf16 (phase 8's inputs, made here, in bf16) of this process's
    checkout, where it has them: checked against the plain versions (the
    six outputs cast to the inputs' dtypes within ``BF16_ULPS`` bf16 units
    of max|.|, the weight gradients' f32 sums within ``DW_RTOL``), timed
    into ``ms``; C-bf16's and H-bf16's f32 sums and D-bf16's and E-bf16's
    dw into ``outputs``."""
    import torch
    from epnet_tpu_torch.ops import conv2d, sa_fused

    if not hasattr(sa_fused, 'fused_point_mlp_max_bwd_bf16_kernel'):
        print(f'{tree}: no bf16 backward kernels', file=sys.stderr)
        return
    dev = torch.device('cuda:0')
    bf = torch.bfloat16

    def bf16_args(args, operands):
        args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        args = [a.to(bf) if i in operands else a for i, a in enumerate(args)]
        args[-1] = args[-1].to(bf).float()  # gout, a bf16 cotangent widened
        return args

    def checked(name, fn, plain, args, inputs):
        got, want = fn(*args), plain(*args)
        for k, x, z in zip(('dy', 'do', 'dw2', 'db2', 'dw3', 'db3'),
                           sa_fused.cast_grads(got, *inputs), sa_fused.cast_grads(want, *inputs)):
            err = float((x.float() - z.float()).abs().max())
            ulp = cs._bf16_ulp(float(z.float().abs().max()))
            if not err <= cs.BF16_ULPS * ulp:
                raise AssertionError(f'{tree}: {name} {k} off by {err:.3e}, one bf16 ulp {ulp:.3e}')
        return [g.cpu() for g in got]

    kernel, plain = sa_fused.fused_point_mlp_max_bwd_bf16_kernel, sa_fused.fused_point_mlp_max_bwd_plain
    for name, args in saved['bwd']:
        args = bf16_args(args, (0, 1, 3, 5))
        key = f'C-bf16 {name} T=256'
        outputs[key] = checked(key, kernel, plain, args, args[:2] + args[3:7])
        ms[key] = cs._time_ms(lambda: kernel(*args), 5)
    kernel = sa_fused.fused_point_mlp_max_win_bwd_bf16_kernel
    args = bf16_args(saved['win_bwd'], (0, 1, 4, 6))
    key = 'H-bf16 rcnn.sa0 T=256'
    outputs[key] = checked(key, kernel, sa_fused.fused_point_mlp_max_win_bwd_plain, args,
                           args[:2] + args[4:8])
    ms[key] = cs._time_ms(lambda: kernel(*args), 5)
    for name, blk, stride, x, dy in cs.dw_cases(dev):
        if name == 'edge':
            continue
        x, dy = x.to(bf), dy.to(bf)
        kernel = conv2d.dw3x3_s2_bf16_kernel if stride == 2 else conv2d.dw3x3_s1_bf16_kernel
        plain = conv2d.dw3x3_s2_plain if stride == 2 else conv2d.dw3x3_s1_plain
        got, want = kernel(x, dy), plain(x, dy)
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= cs.DW_RTOL:
            raise AssertionError(f'{tree}: {name} bf16 off by {err:.3e} at {blk}')
        key = f'{"D" if stride == 2 else "E"}-bf16 {blk}'
        outputs[key] = got.cpu()
        del got, want
        ms[key] = cs._time_ms(lambda: kernel(x, dy), 10)


def worker(tree, out):
    """Time this process's checkout (``tree``, first on sys.path) on the
    saved or made inputs; saves C's and H's gradients, E's dw and F-bf16's
    y and prints one JSON line {case: ms}."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this checkout's, before the tree's path goes first
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from epnet_tpu_torch.ops import fps

    if not os.path.abspath(fps.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise AssertionError(f'{tree}: imported {fps.__file__}')
    ms, outputs = {}, {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    conv_worker(cs, tree, ms, outputs)
    saved = torch.load(os.path.join(out, 'inputs.pt'))
    fps_sa_worker(cs, tree, saved, ms, outputs)
    bf16_worker(cs, tree, saved, ms, outputs)
    bf16_bwd_worker(cs, tree, saved, ms, outputs)
    torch.save(outputs, os.path.join(out, f'grads_{os.getpid()}.pt'))
    print(json.dumps({'tree': tree, 'grads': f'grads_{os.getpid()}.pt', 'ms': ms}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--trees', nargs='+', required=True)
    parser.add_argument('--out', default='output/kernel_turns')
    parser.add_argument('--worker', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.out)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('kernel_turns: needs a CUDA device')
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    os.makedirs(args.out, exist_ok=True)
    make_inputs(os.path.join(args.out, 'inputs.pt'))
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), '--trees', tree,
                               '--out', args.out, '--worker', tree],
                              capture_output=True, text=True, check=False)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f'kernel_turns: {tree} failed ({proc.returncode})')
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    first = torch.load(os.path.join(args.out, runs[0]['grads']))
    for r in runs[1:]:
        for k, got in torch.load(os.path.join(args.out, r['grads'])).items():
            if k not in first:
                continue  # a kernel the first checkout has not
            if torch.is_tensor(got) and '-bf16' in k and k[0] in 'DE':
                # D-bf16/E-bf16's dw: fixed-order f32 sums, but each design sums in its own order
                dist = float((got - first[k]).abs().max() / first[k].abs().max()) / cs.DW_RTOL
                print(f'{r["tree"]} vs {runs[0]["tree"]}, {k}: bitwise equal: '
                      f'{torch.equal(got, first[k])}; max difference {dist:.4f} DW_RTOL of '
                      f'max|dw|')
                continue
            if torch.is_tensor(got):  # E's dw, F-bf16's y: fixed-order sums
                print(f'{r["tree"]} vs {runs[0]["tree"]}, {k}: bitwise equal: '
                      f'{torch.equal(got, first[k])}')
                continue
            (dy, *rest), (dy0, *rest0) = got, first[k]
            if '-bf16' in k:  # C-bf16, H-bf16: each design sums in its own order
                dist = {n: float((a - b).abs().max() / b.abs().max()) / cs.SA_RTOL
                        for n, a, b in zip(('dO', 'dW2', 'db2', 'dW3', 'db3'), rest, rest0)}
                print(f'{r["tree"]} vs {runs[0]["tree"]}, {k}: bitwise equal: '
                      f'{all(torch.equal(a, b) for a, b in zip(got, first[k]))}; max difference '
                      + ', '.join(f'{n} {v:.4f}' for n, v in dist.items())
                      + ' SA_RTOL of max|.|; dY '
                      f'{float((dy - dy0).abs().max() / dy0.abs().max()):.3e} of max|dY|')
                continue
            differ = [n for n, a, b in zip(('dO', 'dW2', 'db2', 'dW3', 'db3'), rest, rest0)
                      if not torch.equal(a, b)]
            print(f'{r["tree"]} vs {runs[0]["tree"]}, {k}: dO, dW and db bitwise equal: '
                  f'{not differ} {differ or ""}; dY differs by at most '
                  f'{float((dy - dy0).abs().max() / dy0.abs().max()):.3e} of max|dY|')
    print('case | ' + ' | '.join(r['tree'] for r in runs))
    cases = list(dict.fromkeys(c for r in runs for c in r['ms']))
    for c in cases:
        print(f'{c} | ' + ' | '.join(f'{r["ms"][c]:.4f}' if c in r['ms'] else '-'
                                     for r in runs))


if __name__ == '__main__':
    main()
