"""Band-schedule sweep of the causal row-band forward, with the monolithic K1 call as control.

Counterpart of ``flash_attention_from_scratch_tpu/tools/tune_bands.py``,
with its options and row keys (``RULES``, ``--band-rows``, ``--block-q``,
``--rules``, ``--window``). At Llama GQA shapes (32/8 heads, batch from
``BATCH_SIZE_FOR_SEQ_LEN``, d 128, bf16) it times the port's
``ops/causal_decomp.py::causal_forward_banded`` (one K1 call a band) at
each band height, and one control row a seq: the monolithic causal K1
call (``flash_forward``), ``band_rows`` the seq and rule ``monolithic``.

On Hopper ``--block-q`` and the wide-band ``--rules`` select no kernel: they
set the TPU hints each band's config carries, and K1 ignores them. So rows
that share a launch (a seq and band height, by
``bench_attention.launch_key`` of each band's config) are timed once and
share its figures, as ``bench_ladder`` does; the tool prints how many
launches its rows share. Timing is the port's ``dispatch.chain_runtime``
(each call's output is the next call's Q), TFLOP/s on the causal FLOP model
(``calc_causal_attn_flop``) against the card's measured matmul rate. The
banded forward lost to one K1 call wherever it was timed on this card
(``banded_case`` in ``chip_smoke.py``); the tool records that and changes
no dispatch. On the card only: raises without one.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.tune_bands \\
        --seq-lens 8192 --csv profiles/traces/bands.csv
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import dataclasses
import json
import os
import sys

from ..dispatch import chain_runtime
from ..ops.causal_decomp import _band_hints, band_slices, causal_forward_banded
from ..ops.configs import KernelConfig, calc_causal_attn_flop
from ..ops.flash_forward import flash_forward
from ..utils.chip import device_kind, measured_matmul_tflops
from ..utils.device import resolve_device
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, generate_qkv
from .bench_attention import launch_key
from .bench_quant import _git_commit

__all__ = ["RULES", "MONOLITHIC", "band_configs", "plan_rows", "main"]

# Named wide-band rules, the JAX tool's: band KV width -> (kv_splits target,
# head_pack target). "default" is the in-tree thresholds
# (ops/causal_decomp.py). TPU hints: on Hopper they select no kernel.
RULES = {
    "default": None,
    "sp16w": lambda w: (16, 1) if w >= 12288 else (
        (4, 2) if w > 8192 else ((2, 4) if w >= 4096 else (2, 4))),
    "sp8hp2": lambda w: (8, 2) if w >= 12288 else (
        (4, 2) if w > 8192 else ((2, 4) if w >= 4096 else (2, 4))),
    "sp4w": lambda w: (4, 1) if w >= 12288 else (
        (4, 2) if w > 8192 else ((2, 4) if w >= 4096 else (2, 4))),
    "sp4hp2w": lambda w: (4, 2) if w > 8192 else (
        (2, 4) if w >= 4096 else (2, 4)),
}
MONOLITHIC = "monolithic"


def base_config(block_q: int, heads: int, kv_heads: int, window: int) -> KernelConfig:
    """The JAX tool's config for one block_q: causal, block_kv 2048, its
    split and pack hints, ``optimized_softmax`` off under a window."""
    group = heads // kv_heads
    hp = next((c for c in (4, 2) if heads % c == 0 and group % c == 0), 1)
    return KernelConfig(block_q=block_q, block_kv=2048, causal=True, kv_splits=2,
                        q_splits=2, head_pack=hp, window=window,
                        optimized_softmax=not window)


def band_configs(cfg: KernelConfig, seq: int, bands: int, rule) -> list[KernelConfig]:
    """The config each band's K1 call gets (``causal_forward_banded``'s)."""
    rows = seq // bands
    out = []
    for row0, kv_start in band_slices(seq, 0, cfg.window, bands):
        width = row0 + rows - kv_start
        out.append(dataclasses.replace(cfg, q_offset=row0 - kv_start, decompose=False,
                                       **_band_hints(cfg, rows, width, rule)))
    return out


def plan_rows(seq: int, heads: int, kv_heads: int, window: int, band_rows, block_qs,
              rules) -> list[tuple[dict, tuple]]:
    """[(row fields, launch key)] of one seq: every (band rows, block_q,
    rule) the JAX tool times, then the monolithic control; rows with equal
    keys run the same launches. The key is the band count and the launch
    keys of the bands' configs."""
    out = []
    for br in band_rows:
        bands = max(1, seq // br)
        for bq in block_qs:
            cfg = base_config(bq, heads, kv_heads, window)
            for rname in rules:
                key = (bands, tuple(launch_key(c) for c in
                                    band_configs(cfg, seq, bands, RULES[rname])))
                out.append((dict(band_rows=br, bands=bands, block_q=bq, rule=rname), key))
    mono = base_config(block_qs[0], heads, kv_heads, window)
    out.append((dict(band_rows=seq, bands=1, block_q=mono.block_q, rule=MONOLITHIC),
                (MONOLITHIC, launch_key(mono))))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq-lens", default="8192,16384")
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rules", default=None,
                    help="comma list from: " + ",".join(RULES) + " (the JAX tool's; "
                         "selects no kernel on Hopper: rows sharing a launch are timed once)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding window (bands clip their KV slice)")
    ap.add_argument("--band-rows", default="512,1024,2048")
    ap.add_argument("--block-q", default="256,512",
                    help="the JAX tool's; selects no kernel on Hopper (rows sharing a "
                         "launch are timed once)")
    ap.add_argument("--json", action="store_true", help="also one JSON line per row")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    mm = measured_matmul_tflops()
    rules = args.rules.split(",") if args.rules else list(RULES)
    band_rows = [int(b) for b in args.band_rows.split(",")]
    block_qs = [int(b) for b in args.block_q.split(",")]
    commit = _git_commit()
    print(f"device={device_kind()} commit={commit} ceiling={mm:.1f}")
    rows = []
    for seq in [int(s) for s in args.seq_lens.split(",")]:
        batch = BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4)
        q, _, _ = generate_qkv(seq, n_heads=args.heads, batch=batch, device=dev)
        _, k, v = generate_qkv(seq, n_heads=args.kv_heads, batch=batch, seed=1, device=dev)
        flops = calc_causal_attn_flop(seq, 128, args.heads, batch, window=args.window)
        planned = plan_rows(seq, args.heads, args.kv_heads, args.window, band_rows,
                            block_qs, rules)
        timed: dict[tuple, tuple] = {}
        for fields, key in planned:
            if key not in timed:
                bq = fields["block_q"]
                cfg = base_config(bq, args.heads, args.kv_heads, args.window)
                if fields["rule"] == MONOLITHIC:
                    def step(x, k_, v_, cfg=cfg):
                        return flash_forward(x, k_, v_, cfg)
                else:
                    def step(x, k_, v_, cfg=cfg, n=fields["bands"],
                             rule=RULES[fields["rule"]]):
                        return causal_forward_banded(x, k_, v_, cfg, bands=n,
                                                     band_rules=rule)[0]
                try:
                    secs = chain_runtime(step, q, k, v, iters=args.iters,
                                         est_secs=flops / 500e12)
                    timed[key] = (secs, "")
                except ValueError as e:  # the bands do not split seq into K1's rows
                    timed[key] = (None, f"{type(e).__name__}: {str(e)[:120]}")
            secs, error = timed[key]
            tf = flops / secs / 1e12 if secs else 0.0
            rows.append(dict(seq=seq, batch=batch, heads=args.heads,
                             kv_heads=args.kv_heads, window=args.window, **fields,
                             kernel="flash_forward" if fields["rule"] == MONOLITHIC
                             else "flash_forward_banded",
                             ms=round(secs * 1e3, 4) if secs else None,
                             tflops=round(tf, 2), pct_matmul=round(100 * tf / mm, 2),
                             timing="chain", error=error, commit=commit))
            r = rows[-1]
            print(f"  seq {seq} rows{r['band_rows']} bq{r['block_q']} {r['rule']:>10}: "
                  + (f"{tf:7.2f} TFLOP/s ({r['pct_matmul']:5.1f}% mm)" if secs else error))
        print(f"  seq {seq}: --block-q and --rules select no kernel on Hopper: "
              f"{len(planned)} rows share {len(timed)} launches")
        del q, k, v
    mono = {r["seq"]: r["tflops"] for r in rows if r["rule"] == MONOLITHIC}
    for r in rows:
        r["vs_monolithic"] = round(r["tflops"] / mono[r["seq"]], 4) if mono[r["seq"]] else None
    rows.sort(key=lambda r: (r["seq"], -r["tflops"]))
    if args.json:
        for r in rows:
            print(json.dumps(r))
    if args.csv and rows:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w", newline="") as f:
            w = csv_mod.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
