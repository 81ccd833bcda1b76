"""Where kernel B4's time goes, by ablation, on one CUDA card.

    python -m dcd_isaac_tpu_torch.kernels.ablate_teacher_proj \
        [--batches 864,53248] [--n 1024] [--variants full,no_mma,...]

Builds ``csrc/teacher_proj.cu`` as it is and in variants that each take
one part of the work out or change a choice, then times the forward and
the backward's dW and dA kernels of each at the teacher's shapes (15x15
images, conv-128, E = 60, W_i N x 21 692, N = 1024 or 64) with CUDA
events, the variants in turn within each sample:

  full        the kernels as shipped;
  no_mma      the tensor-core products are replaced by one integer op on
              their operands (the fragment loads stay);
  no_product  the products and their fragment loads are left out;
  no_cluster  every dW CTA computes its whole conv tile (no clusters);
  no_fetch    W_i and g are not read (ones are staged in their place);
  no_stage    the main loops stage nothing after the first step (no
              splits, no conv, no stores of operand tiles);
  no_conv     the conv keeps its bias and drops its 27 products;
  no_split    operands are stored unsplit (hi = the fp32 value, lo = 0),
              without cvt;
  no_narrow   the forward at N <= 64 takes the 128 x 128 tile of N = 1024
              instead of its 128 x 64 one;

and any of them joined by '+'.

The no_* variants but no_narrow compute wrong results: they only say what
each part costs.  Prints each variant's registers and spills from
``ptxas``, then one JSON line per batch with each variant's median ms
and the card's name and power limit.  The builds run in parallel, one ``nvcc`` each, into
``_build/ablation/``.  Nothing in the port imports this module's work.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

from . import _build

# (variant, [(a short marker in the source, its replacement)]); every
# marker must occur in the source, and each occurrence is replaced.
VARIANTS = {
    'full': [],
    'no_mma': [(
        'const uint32_t (&b)[2]) {\n',
        'const uint32_t (&b)[2]) {\n'
        '  d[0] = __uint_as_float(__float_as_uint(d[0]) ^ a[0] ^ a[1] ^ a[2]'
        ' ^ a[3] ^ b[0] ^ b[1]);\n'
        '  return;\n')],
    'no_product': [
        ('i < MT; ++i) mma_tf32(', 'i < 0; ++i) mma_tf32(')],
    'no_fetch': [
        ('? ldg4(w + (size_t)n * K + k)', '? make_float4(1.f, 1.f, 1.f, 1.f)'),
        ('? ldg4(g + (size_t)row * N + n)',
         '? make_float4(1.f, 1.f, 1.f, 1.f)')],
    'no_cluster': [('cluster_size(dw_grid.y)', '1')],
    'no_stage': [
        ('if (next) stage(s + 1, q);', '(void)next;'),
        ('if (s + 1 < steps) stage(s + 1);', '')],
    'no_conv': [('q < kPatch; ++q) {\n    const float4 w4',
                 'q < 0; ++q) {\n    const float4 w4')],
    'no_split': [(
        'split4(float4 v, float4& h, float4& l) {\n',
        'split4(float4 v, float4& h, float4& l) {\n'
        '  h = v;\n'
        '  l = make_float4(0.f, 0.f, 0.f, 0.f);\n'
        '  return;\n')],
    'no_narrow': [('N <= 64 ? kFwdNarrow : kFwdWide', 'kFwdWide')],
}


def variant_source(name) -> str:
    """The source with the edits of each variant in ``name``, joined by
    '+' (``no_cluster+no_stage``)."""
    with open(os.path.join(_build.CSRC, 'teacher_proj.cu')) as f:
        src = f.read()
    for old, new in (e for part in name.split('+') for e in VARIANTS[part]):
        if old not in src:
            raise RuntimeError(f'ablation edit does not apply:\n{old}')
        src = src.replace(old, new)
    return src


def build_all(names) -> dict:
    """{variant: (library path, ptxas report)}, one nvcc per variant, all
    started together."""
    out_dir = os.path.join(_build.BUILD_DIR, 'ablation')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(out_dir, f'{name}.cu')
        with open(src, 'w') as f:
            f.write(variant_source(name))
        lib = os.path.join(out_dir, f'{name}.so')
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v',
               '-o', lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    try:
        for name, (lib, proc) in procs.items():
            report, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed for {name}:\n{report}')
            built[name] = (lib, [line.strip() for line in report.splitlines()
                                 if 'registers' in line or 'spill' in line])
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return built


def inputs(batch: int, n_out: int, device):
    """The teacher's projection inputs at its widths, random, and an
    upstream gradient."""
    import torch
    g = torch.Generator(device=device).manual_seed(batch)
    img = torch.randint(0, 11, (batch, 15, 15, 3), generator=g,
                        device=device, dtype=torch.uint8)
    shapes = ((128, 3, 3, 3), (128,), (batch, 60), (n_out, 21692),
              (batch, n_out))
    scales = (0.15, 0.05, 1.0, 0.007, 1.0)
    return [img] + [torch.randn(s, generator=g, device=device) * k
                    for s, k in zip(shapes, scales)]


def launchers(path: str, img, conv_w, conv_b, e, w_i, grad) -> dict:
    """{'forward', 'dw', 'da'}: functions launching the library at
    ``path`` on these inputs."""
    import torch
    lib = ctypes.CDLL(path)
    for name in ('dcd_teacher_proj', 'dcd_teacher_proj_workspace',
                 'dcd_teacher_proj_backward',
                 'dcd_teacher_proj_backward_workspace'):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
    B, X, Y, _ = img.shape
    C, (N, K), E = conv_w.shape[0], w_i.shape, e.shape[1]
    dev = img.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((B, N), device=dev)
    ws = torch.empty(max(lib.dcd_teacher_proj_workspace(B, N, K, C, E), 4),
                     device=dev)
    grads = [torch.empty_like(t) for t in (w_i, conv_w, conv_b, e)]
    bws = torch.empty(
        max(lib.dcd_teacher_proj_backward_workspace(B, N, K, C, E), 4),
        device=dev)

    def forward():
        _build.check(lib.dcd_teacher_proj(
            img.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
            e.data_ptr(), w_i.data_ptr(), out.data_ptr(), ws.data_ptr(), B,
            X, Y, C, E, N, stream), 'teacher_proj ablation')

    def backward(parts):
        _build.check(lib.dcd_teacher_proj_backward(
            img.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
            e.data_ptr(), w_i.data_ptr(), grad.data_ptr(),
            *(t.data_ptr() for t in grads), bws.data_ptr(), B, X, Y, C, E,
            N, parts, stream), 'teacher_proj backward ablation')
    return {'forward': forward, 'dw': lambda: backward(1),
            'da': lambda: backward(2)}


def event_ms(fn) -> float:
    """Device ms of one ``fn`` call, from CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def interleaved_ms(fns: dict, samples: int = 7) -> dict:
    """{variant: {part: median ms}} of ``fns`` ({variant: {part: fn}}),
    each part of each variant timed once a sample, in turn, after one
    warm-up call of each."""
    import torch
    for parts in fns.values():
        for fn in parts.values():
            fn()
    torch.cuda.synchronize()
    times = {v: {k: [] for k in parts} for v, parts in fns.items()}
    for _ in range(samples):
        for v, parts in fns.items():
            for k, fn in parts.items():
                times[v][k].append(event_ms(fn))
    return {v: {k: statistics.median(t) for k, t in parts.items()}
            for v, parts in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batches', default='864,53248')
    ap.add_argument('--n', type=int, default=1024,
                    help='W_i rows: 1024 (the LSTM input) or 64')
    ap.add_argument('--variants', default=','.join(VARIANTS))
    cli = ap.parse_args(argv)
    import torch
    from .. import resolve_device
    device = resolve_device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    built = build_all(cli.variants.split(','))
    for name, (_, report) in built.items():
        print(json.dumps({'variant': name, 'ptxas': report}), flush=True)
    for batch in (int(b) for b in cli.batches.split(',')):
        args = inputs(batch, cli.n, device)
        ms = interleaved_ms({name: launchers(path, *args)
                             for name, (path, _) in built.items()})
        print(json.dumps({'B': batch, 'N': cli.n, 'ms': ms, 'card': smi}),
              flush=True)
        del args
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
