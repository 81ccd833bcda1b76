"""Where kernel B3's time goes, by ablation, on one CUDA card.

    python -m dcd_isaac_tpu_torch.kernels.ablate_lstm_seq \
        [--n 32,8192] [--t 256] [--variants full,no_product,...] [--dw]

Builds ``csrc/lstm_seq.cu`` as it is and in variants that each take one
part of the work out or change a choice, then times the forward and the
backward kernel (without the dW_h matmul) of each at LSTM-256 with CUDA
events, the variants in turn within each sample:

  full         the kernels as shipped;
  no_product   the gate product (z = m h W_h^T, both passes) is left out;
  no_dh        the backward's dz @ W_h product is left out (its zeros are
               still sent);
  no_exchange  nothing moves between the CTAs of a cluster: no copies or
               sends, no waits on the mbarriers;
  no_free      the backward sends and waits for its partial sums but not
               for the signal that the last ones were read;
  cta_acquire  the mbarrier waits acquire at CTA scope, not the
               cluster's;
  bm16, bm32   every launch takes BM = 16, or 32;

and any of them joined by '+'.

The no_* and cta_acquire variants compute wrong results: they only say
what each part costs.  ``--dw`` instead reports B3's dW_h at T = 256,
N = 8192 (``dw_report``): ``weight_grads`` in float64 against one fp32
matmul, each timed, and for each how far the kernel's dW lies from the
twin's, against the 1e-4 + 1e-4·|ref| that the smoke holds it to.  Prints each variant's registers and spills from
``ptxas``, then one JSON line per N with each variant's median ms and the
card's name and power limit.  The builds run in parallel, one ``nvcc``
each, into ``_build/ablation/``.  Nothing in the port imports this
module's work.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

from . import _build
from .ablate_teacher_proj import interleaved_ms

# (variant, [(a short marker in the source, its replacement)]); every
# marker must occur in the source, and each occurrence is replaced.
VARIANTS = {
    'full': [],
    'no_product': [('for (int k = k0; k < k1; k += 16) {',
                    'for (int k = k0; k < k0; k += 16) {')],
    'no_dh': [('for (int k = 0; k < kCols; k += 8) {',
               'for (int k = 0; k < 0; k += 8) {')],
    'no_exchange': [
        ('if (t > 0) mbar_wait(', 'if (false) mbar_wait('),
        ('if (R.gtid == 0 && t + 1 < T) mbar_expect(',
         'if (false) mbar_expect('),
        ('if (t + 1 < T) {\n      // m_{t+1}', 'if (false) {\n      //'),
        ('send_dh_parts<BM>(dzb, whi,', 'return;\n    send_dh_parts<BM>(dzb, '
                                          'whi,'),
        ('    mbar_wait(got, e & 1);\n', ''),
        ('if (R.gtid == 0 && e + 1 < T) mbar_expect(got',
         'if (false) mbar_expect(got'),
        ('if (read_parts && R.gtid < C) send_token(',
         'if (false) send_token(')],
    'no_free': [
        ('if (e == 0) return;', 'return;'),
        ('if (read_parts && R.gtid < C) send_token(',
         'if (false) send_token(')],
    'cta_acquire': [('try_wait.parity.acquire.cluster.shared::cta',
                     'try_wait.parity.acquire.cta.shared::cta')],
    'bm16': [('const bool small = n16 > 0 &&', 'const bool small = true ||')],
    'bm32': [('const bool small = n16 > 0 &&',
              'const bool small = false &&')],
}


def variant_source(name) -> str:
    """The source with the edits of each variant in ``name``, joined by
    '+' (``no_exchange+bm32``)."""
    with open(os.path.join(_build.CSRC, 'lstm_seq.cu')) as f:
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
        src = os.path.join(out_dir, f'lstm_{name}.cu')
        with open(src, 'w') as f:
            f.write(variant_source(name))
        lib = os.path.join(out_dir, f'lstm_{name}.so')
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


def inputs(T: int, N: int, device):
    """B3's inputs at LSTM-256 (W_h of a fresh core, resets at t = 0 and
    about one step in twenty), the forward's outputs' buffers and the
    backward's cotangents."""
    import torch
    from ..models.common import RNNCore
    core = RNNCore(4, 256, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=device).manual_seed(N)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    masks = (torch.rand((T, N), generator=g, device=device) > 0.05).float()
    masks[0, ::2] = 0.0
    return dict(zx=rn(T, N, 1024), masks=masks,
                w_h=core.w_h.weight.detach().to(device), b=rn(1024) * 0.1,
                c0=rn(N, 256), h0=rn(N, 256), c_all=rn(T, N, 256),
                h_all=rn(T, N, 256), dh_all=rn(T, N, 256), dc=rn(N, 256),
                dzx=torch.empty((T, N, 1024), device=device),
                dh0=torch.empty((N, 256), device=device))


def launchers(path: str, x: dict) -> dict:
    """{'forward', 'backward'}: functions launching the library at
    ``path`` on the inputs ``x`` (outputs overwritten each call)."""
    import torch
    lib = ctypes.CDLL(path)
    for name in ('dcd_lstm_seq_forward', 'dcd_lstm_seq_backward'):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
    T, N, _ = x['zx'].shape
    stream = torch.cuda.current_stream(x['zx'].device).cuda_stream
    p = {k: v.data_ptr() for k, v in x.items()}
    c_out = torch.empty_like(x['c_all'])
    h_out = torch.empty_like(x['h_all'])
    dc = torch.empty_like(x['dc'])

    def forward():
        _build.check(lib.dcd_lstm_seq_forward(
            p['zx'], p['masks'], p['w_h'], p['b'], p['c0'], p['h0'],
            c_out.data_ptr(), h_out.data_ptr(), T, N, 256, stream),
            'lstm_seq ablation')

    def backward():
        dc.copy_(x['dc'])
        _build.check(lib.dcd_lstm_seq_backward(
            p['zx'], p['masks'], p['w_h'], p['b'], p['c0'], p['h0'],
            p['c_all'], p['h_all'], p['dh_all'], dc.data_ptr(), p['dzx'],
            p['dh0'], T, N, 256, stream), 'lstm_seq backward ablation')
    return {'forward': forward, 'backward': backward}


def dw_report(device, T=256, N=8192) -> dict:
    """dW_h from the kernel's and from the twin's dz at (T, N), by
    ``weight_grads`` (float64) and by one fp32 matmul over all T·N rows:
    the kernel's against the twin's at the smoke's tolerance, and each
    route's median ms of 3 on the kernel's dz."""
    import torch
    from . import lstm_seq as ls
    from .ablate_teacher_proj import event_ms
    x = inputs(T, N, device)
    for k in ('c_all', 'h_all', 'dzx'):    # the forward's own replace them
        del x[k]
    args = tuple(x[k] for k in ('zx', 'masks', 'w_h', 'b', 'c0', 'h0'))
    g_h, g_c = x['dh_all'], x['dc']
    masks, h0 = x['masks'], x['h0']

    def fp32(dz, h_all):
        hp = torch.cat([h0[None], h_all[:-1]]) * masks[..., None]
        return torch.matmul(dz.reshape(-1, dz.shape[-1]).T,
                            hp.reshape(-1, hp.shape[-1]))

    def float64(dz, h_all):
        return ls.weight_grads(dz, masks, h0, h_all)[0]

    out = {'T': T, 'N': N}
    with torch.no_grad():
        h_k, c_k = ls._launch_forward(*args)
        dz_k = ls._backward_kernel(g_h, g_c, *args, h_k, c_k)[0]
        del c_k
        h_t, c_t, _ = ls.lstm_seq_plain_forward(*args)
        dz_t = ls.lstm_seq_plain_backward(g_h, g_c, *args, h_t, c_t)[0]
        del c_t
        for name, route in (('float64', float64), ('fp32_matmul', fp32)):
            a, b = route(dz_k, h_k).double(), route(dz_t, h_t).double()
            err = (a - b).abs()
            tol = 1e-4 + 1e-4 * b.abs()
            out[name] = {
                'max_abs_err': float(err.max()),
                'max_err_over_tol': float((err / tol).max()),
                'n_over_tol': int((err > tol).sum()),
                'ms': statistics.median(
                    event_ms(lambda: route(dz_k, h_k)) for _ in range(3))}
            del a, b, err, tol
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', default='32,8192')
    ap.add_argument('--t', type=int, default=256)
    ap.add_argument('--variants', default=','.join(VARIANTS))
    ap.add_argument('--dw', action='store_true',
                    help="report dW_h's routes instead (dw_report)")
    cli = ap.parse_args(argv)
    import torch
    from .. import resolve_device
    device = resolve_device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if cli.dw:
        print(json.dumps({**dw_report(device), 'card': smi}), flush=True)
        return 0
    built = build_all(cli.variants.split(','))
    for name, (_, report) in built.items():
        print(json.dumps({'variant': name, 'ptxas': report}), flush=True)
    for n in (int(v) for v in cli.n.split(',')):
        x = inputs(cli.t, n, device)
        ms = interleaved_ms({name: launchers(path, x)
                             for name, (path, _) in built.items()},
                            samples=7 if n <= 1024 else 3)
        print(json.dumps({'T': cli.t, 'N': n, 'ms': ms, 'card': smi}),
              flush=True)
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
