"""Where kernel B4's time goes, by ablation, on one CUDA card.

    python -m dcd_isaac_tpu_torch.kernels.ablate_teacher_proj \
        [--batches 32,864]

Builds ``csrc/teacher_proj.cu`` as it is and in variants that each take
one part of the work out, then times each at the teacher's shapes (15x15
images, conv-128, E = 60, W_i 1024 x 21 692) with CUDA graph replays:

  full        the kernel as shipped;
  no_conv     the prologue writes the bias where the 27-term conv was;
  no_product  the product's loop is skipped (no shared loads, no FMAs);
  no_copy     no copies of W_i into shared memory (stale tiles are used).

The variants compute wrong results: they only say what each part costs.
Prints each variant's registers and spills from ``ptxas``, then one JSON
line per batch with each variant's ms and the card's name and power
limit.  The builds run in parallel, one ``nvcc`` each, into
``_build/ablation/``.  Nothing in the port imports this module's work.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

from . import _build

# (variant, [(text in the source, its replacement)]).
VARIANTS = {
    'full': [],
    'no_conv': [(
        '          v.x = fmaf(w4.x, x, v.x);\n'
        '          v.y = fmaf(w4.y, x, v.y);\n'
        '          v.z = fmaf(w4.z, x, v.z);\n'
        '          v.w = fmaf(w4.w, x, v.w);\n',
        '          (void)x;\n          (void)w4;\n')],
    'no_product': [(
        '    for (int kk = 0; kk < kBK; kk += 4) {\n',
        '    for (int kk = 0; kk < 0; kk += 4) {\n')],
    'no_copy': [(
        '        __pipeline_memcpy_async(d, w + (size_t)n * K + k, 16);\n',
        '        (void)d;\n')],
}


def variant_source(edits) -> str:
    with open(os.path.join(_build.CSRC, 'teacher_proj.cu')) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'ablation edit does not apply:\n{old}')
        src = src.replace(old, new)
    return src


def build_all() -> dict:
    """{variant: (library path, ptxas report)}, one nvcc per variant, all
    started together."""
    out_dir = os.path.join(_build.BUILD_DIR, 'ablation')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(out_dir, f'{name}.cu')
        with open(src, 'w') as f:
            f.write(variant_source(edits))
        lib = os.path.join(out_dir, f'{name}.so')
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v',
               '-o', lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{report}')
        built[name] = (lib, [line.strip() for line in report.splitlines()
                             if 'registers' in line or 'spill' in line])
    return built


def inputs(batch: int, device):
    """The teacher's projection inputs at its widths, random."""
    import torch
    g = torch.Generator(device=device).manual_seed(batch)
    img = torch.randint(0, 11, (batch, 15, 15, 3), generator=g,
                        device=device, dtype=torch.uint8)
    shapes = ((128, 3, 3, 3), (128,), (batch, 60), (1024, 21692))
    scales = (0.15, 0.05, 1.0, 0.007)
    return [img] + [torch.randn(s, generator=g, device=device) * k
                    for s, k in zip(shapes, scales)]


def launcher(path: str, img, conv_w, conv_b, e, w_i):
    """A function launching the library at ``path`` on these inputs."""
    import torch
    lib = ctypes.CDLL(path)
    lib.dcd_teacher_proj.argtypes = _build.SIGNATURES['dcd_teacher_proj']
    lib.dcd_teacher_proj_workspace.argtypes = _build.SIGNATURES[
        'dcd_teacher_proj_workspace']
    B, X, Y, _ = img.shape
    C, (N, K), E = conv_w.shape[0], w_i.shape, e.shape[1]
    ws_floats = lib.dcd_teacher_proj_workspace(B, N, K, C)
    out = torch.empty((B, N), device=img.device)
    ws = torch.empty(max(ws_floats, 1), device=img.device)

    def launch():
        rc = lib.dcd_teacher_proj(
            img.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
            e.data_ptr(), w_i.data_ptr(), out.data_ptr(), ws.data_ptr(), B,
            X, Y, C, E, N,
            torch.cuda.current_stream(img.device).cuda_stream)
        _build.check(rc, 'teacher_proj ablation')
    return launch


def graph_ms(fn, inner: int = 10, samples: int = 25) -> float:
    """Median device ms of one ``fn`` launch, from CUDA graph replays of
    ``inner`` launches timed with CUDA events."""
    import statistics
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batches', default='32,864')
    cli = ap.parse_args(argv)
    import torch
    from .. import resolve_device
    device = resolve_device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    built = build_all()
    for name, (_, report) in built.items():
        print(json.dumps({'variant': name, 'ptxas': report}), flush=True)
    for batch in (int(b) for b in cli.batches.split(',')):
        args = inputs(batch, device)
        ms = {name: graph_ms(launcher(path, *args))
              for name, (path, _) in built.items()}
        torch.cuda.synchronize()
        print(json.dumps({'B': batch, 'ms': ms, 'card': smi}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
