"""On the card: ``chip_smoke.py``'s ``train_parallel`` checks against
planted faults.

Runs the smoke's training comparison (Llama-3-8B's width at 2 layers, 3
AdamW steps from seed 0, one rank against 2 gloo ranks on card 0) with a
fault planted in the ranks, and prints, for each, the gaps that the
smoke's two checks read: the losses' (``TRAIN_PARALLEL_GAP``) and the
first-step gradients' (``_grad_gaps``, ``TRAIN_PARALLEL_GRAD_GAP``).

- ``sp_timed``: no fault, on the sp mesh, with the time of each step's
  ``sum_data_gradients`` (the gloo all-reduce of the gradients);
- ``sp_no_sum``: the gradient sum over sp left out;
- ``tp_half_copy_to``: ``copy_to``'s gradient all-reduce halved.

Each fault should fail the checks; the run without one should pass them.
Not a test module (pytest does not collect it). Run from the repository
root on a machine with a card::

    python3 tests/chip_train_faults.py
"""

import json
import os
import sys
import time
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def fault_rank(rank, world):
    from flash_attention_from_scratch_tpu_torch.models import train
    from flash_attention_from_scratch_tpu_torch.parallel import collectives
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_mesh, make_sp_mesh

    kw = dict(device=cs.PARALLEL_DEVICE, backend=cs.PARALLEL_BACKEND)
    out = {}
    real, took = train.sum_data_gradients, []

    def timed(params, mesh):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(params, mesh)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t)

    with mock.patch.object(train, "sum_data_gradients", timed):
        out["sp_timed"] = cs._train_run(make_sp_mesh(world, **kw))
    out["sp_timed"]["sum_s"] = took
    torch.cuda.empty_cache()
    with mock.patch.object(train, "sum_data_gradients", lambda params, mesh: None):
        out["sp_no_sum"] = cs._train_run(make_sp_mesh(world, **kw))
    torch.cuda.empty_cache()
    half = staticmethod(lambda ctx, g: (collectives._all_reduce(g, ctx.mesh, ctx.axis) / 2,
                                        None, None))
    with mock.patch.object(collectives._CopyTo, "backward", half):
        out["tp_half_copy_to"] = cs._train_run(make_mesh(1, world, **kw))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_train_faults: no CUDA device", file=sys.stderr)
        return 2
    cs.phase_device()  # the card's name and power limit, as the smoke prints them
    single = cs._train_run()
    torch.cuda.empty_cache()
    both = cs._spawn(fault_rank, 2)
    for kind in ("sp_timed", "sp_no_sum", "tp_half_copy_to"):
        ranks = [r[kind] for r in both]
        gaps = cs._grad_gaps(single["grads"], ranks)
        worst = [max(g[k] for g in gaps.values()) for k in (0, 1)]
        loss_gaps = [abs(a - b) for a, b in zip(ranks[0]["losses"], single["losses"])]
        print(json.dumps({kind: {
            "losses": [r["losses"] for r in ranks], "single": single["losses"],
            "loss_gaps": loss_gaps, "loss_check_fails": max(loss_gaps) > cs.TRAIN_PARALLEL_GAP,
            "grad_norm_gap": worst[0], "grad_proj_gap": worst[1],
            "grad_check_fails": max(worst) > cs.TRAIN_PARALLEL_GRAD_GAP,
            "worst_leaves": sorted(gaps.items(), key=lambda kv: -max(kv[1]))[:3],
            "step_s": [r["step_s"] for r in ranks], "sum_s": ranks[0].get("sum_s"),
            "staged_bytes": [r["staged_bytes"] for r in ranks]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
