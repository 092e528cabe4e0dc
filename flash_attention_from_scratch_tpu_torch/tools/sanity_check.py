"""Quick numerics check across kernel configs against the reference pair.

Counterpart of ``flash_attention_from_scratch_tpu/tools/sanity_check.py``:
each selected config (``--kernels``, ``--kernel N`` an index into them,
``--dtype``) runs the port's ``flash_forward`` (the kernel its
``bench_attention.kernel_of`` names on the card, the plain version with
``--device cpu``) on ``generate_qkv`` inputs, and its output is held to
``ops/reference.py::reference_pair`` (with the config's mask and softcap)
by ``utils/testing.py::adaptive_tolerance_check``; mismatch counts and the
largest difference are printed a config. ``--small`` is batch 1, one head,
seq 512. A config whose blocks do not tile the seq is skipped (JAX's
rule). ``--dtype f32`` runs K1's and K11's fp32 libraries (JAX's ``prog``
has no fp32 config: name their ``fa_f32_`` short forms in ``--kernels``);
there the reference pair is one fp32 computation and the rule's fp32
floors bound the kernel. A config the wrapper refuses counts as a
failure, never a pass.

Exit codes, the JAX tool's: 0 when every config passed, 1 when any failed,
2 when no config matched or every one was skipped.

Usage:
    python -m flash_attention_from_scratch_tpu_torch.tools.sanity_check --kernels prog
    python -m flash_attention_from_scratch_tpu_torch.tools.sanity_check --small --kernel 3
    python -m flash_attention_from_scratch_tpu_torch.tools.sanity_check --dtype f32 \\
        --kernels 'fa_f32_q128_kv128_d128_grid2_x2+os+cp;fa_f32_q128_kv128_d128_fori2_x2+os+cp'
"""

from __future__ import annotations

import argparse
import sys

from ..ops.configs import DType, get_kernel_configs
from ..ops.flash_forward import flash_forward
from ..ops.reference import reference_pair
from ..utils.device import resolve_device
from ..utils.testing import adaptive_tolerance_check, error_stats, generate_qkv
from .bench_attention import kernel_of

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="prog")
    ap.add_argument("--kernel", type=int, default=None,
                    help="index into the selected config list")
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--small", action="store_true", help="batch 1, seq 512, 1 head")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.small:
        args.batch, args.seq, args.heads = 1, 512, 1

    dtype = DType.from_short(args.dtype)
    configs = [c for c in get_kernel_configs(args.kernels) if c.dtype == dtype]
    if not configs:
        print(f"no configs matched --kernels {args.kernels} --dtype {args.dtype}")
        return 2  # nothing checked must not read as a pass
    if args.kernel is not None:
        configs = [configs[args.kernel]]

    q, k, v = generate_qkv(args.seq, n_heads=args.heads, batch=args.batch,
                           dtype=dtype.torch_dtype, device=dev)
    refs = {}
    n_bad = n_ran = 0
    for cfg in configs:
        name = f"{cfg.short_form():<48} {kernel_of(cfg):<24}"
        if args.seq % cfg.block_q or args.seq % cfg.block_kv:
            print(f"{name} SKIP (seq {args.seq} not tileable)")
            continue
        n_ran += 1
        mask = (cfg.causal, cfg.q_offset, cfg.window, cfg.attn_softcap)
        if mask not in refs:
            refs[mask] = reference_pair(q, k, v, causal=cfg.causal,
                                        q_offset=cfg.q_offset if cfg.causal else None,
                                        window=cfg.window, softcap=cfg.attn_softcap)
        ref_native, ref_fp32 = refs[mask]
        try:
            out = flash_forward(q, k, v, cfg)
        except ValueError as e:  # the wrapper refuses the inputs
            n_bad += 1
            print(f"{name} BAD refused: {e}")
            continue
        ok, kerr, berr = adaptive_tolerance_check(out, ref_native, ref_fp32)
        n_bad += not ok
        print(f"{name} {'OK ' if ok else 'BAD'} kerr={kerr:.3e} (2x-bound from "
              f"{berr:.3e}) {error_stats(out, ref_native)}")
    if n_ran == 0:
        print("every config was skipped (tileability): nothing checked")
        return 2
    print(f"{n_ran - n_bad} of {n_ran} configs passed")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
