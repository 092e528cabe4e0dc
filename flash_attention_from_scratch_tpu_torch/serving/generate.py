"""Continuous-batching generation: native scheduler + the port's kernels.

Counterpart of ``flash_attention_from_scratch_tpu/serving/generate.py``
``GenerationServer`` for greedy decoding over a dense or quantized (int8,
fp8, int4) KV cache; the parameters may hold quantized weights
(``models.llama.quantize_params``). Requests enter the native scheduler
(``serving.runtime.PagedEngine``); each step admits what fits, prefills
newly admitted prompts through the flash forward kernel, and advances every
running sequence through the paged decode kernel: one token, or with
``spec_k`` a prompt-lookup draft of up to ``spec_k`` tokens verified in one
multi-token pass (``models.decode.verify_step``). ``attn_int8`` runs the
paged kernel in int8 compute on an int8 cache. The decode batch is padded
to ``max_batch``; padding rows write their K/V to a reserved scratch page.

Token bookkeeping matches the scheduler's accounting: after ``step()`` a
sequence's length counts its prompt plus committed tokens; the token
generated this step writes K/V at position ``length - 1``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models.decode import (
    check_no_sinks, decode_step, greedy_token, init_cache, prefill,
    spec_accept_sample, verify_step,
)
from ..models.llama import LlamaConfig
from ..utils.device import resolve_device
from .runtime import PagedEngine

__all__ = ["GenerationServer"]

PROMPT_QUANTUM = 128  # prompts are right-padded to a multiple of this


def _prompt_lookup_draft(ctx: list[int], k: int, ngram: int = 2) -> list[int]:
    """Draft up to k tokens by continuing the latest earlier occurrence of
    the context's final ``ngram``: prompt-lookup decoding, no draft model.
    Returns [] when the n-gram never occurred before (the verify step then
    decodes one token)."""
    if len(ctx) <= ngram:
        return []
    key = ctx[-ngram:]
    for i in range(len(ctx) - ngram - 1, -1, -1):
        if ctx[i:i + ngram] == key:
            return list(ctx[i + ngram:i + ngram + k])
    return []


def _pad_to_multiple(tokens: list[int], quantum: int = PROMPT_QUANTUM) -> np.ndarray:
    n = len(tokens)
    out = np.zeros(n + (-n) % quantum, np.int64)
    out[:n] = tokens
    return out


@dataclasses.dataclass
class _SeqState:
    prompt: list[int]
    generated: list[int]
    max_new: int = 0
    prefilled: bool = False
    stop: frozenset = frozenset()
    # Wall clock: submit -> first token -> finished.
    submit_t: float = 0.0
    first_t: float = 0.0
    done_t: float = 0.0


class GenerationServer:
    """Greedy continuous-batching generation over a paged KV cache.

    ``num_pages`` is the total pool; one page is reserved as the scratch
    target for decode-batch padding rows, the rest belong to the scheduler.
    ``params`` must live on ``device`` (default: the card; without one the
    constructor raises). ``mode`` is the KV cache format: "dense", "int8",
    "fp8" or "int4". ``spec_k`` (1 to page_size - 1) drafts that many tokens
    by prompt lookup and verifies them in one pass whenever the whole batch
    is decoding and nothing waits; ``attn_int8`` (int8 cache only) runs the
    paged kernel's int8 compute. Options of the JAX server that are not
    ported yet raise ``NotImplementedError``; ``seed`` only seeds sampling,
    which is one of them. A config with attention sinks, and a ``chunk``
    outside [1, page_size], raise ``ValueError``.
    """

    def __init__(self, params, cfg: LlamaConfig, *, num_pages: int,
                 page_size: int, max_batch: int,
                 pages_per_seq: int | None = None, mode: str = "dense",
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 chunk: int = 1,
                 attn_int8: bool = False, mesh=None,
                 prefill_chunk_tokens: int = 0, spec_k: int = 0,
                 prefix_cache: bool = False, lora=None, device="cuda"):
        if attn_int8 and mode != "int8":
            raise ValueError(f"attn_int8 requires an int8 KV cache; mode={mode!r}")
        check_no_sinks(cfg)
        if not 1 <= chunk <= page_size:
            # Padding rows park their chunk KV in the single scratch page,
            # so a chunk may not outgrow it.
            raise ValueError(f"chunk must be in [1, page_size]; got {chunk}")
        if spec_k:
            if chunk > 1:
                raise ValueError("spec_k and chunk>1 are exclusive decode strategies")
            if not 1 <= spec_k + 1 <= page_size:
                # Padding rows park their t = spec_k + 1 tokens in the single
                # scratch page.
                raise ValueError(f"spec_k must be in [1, page_size - 1]; got {spec_k}")
        unported = {"temperature > 0 (sampling)": temperature > 0,
                    "top_k > 0 (sampling)": top_k > 0,
                    "chunk > 1 (multi-token decode loop)": chunk > 1,
                    "prefix_cache": prefix_cache,
                    "prefill_chunk_tokens (chunked prefill)": prefill_chunk_tokens,
                    "lora": lora is not None,
                    "mesh (tensor-parallel serving)": mesh is not None}
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(
                    f"{what} is not ported yet (see ROADMAP.md, Queue 1)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"server on {self.device}")
        self.params = params
        self.cfg = cfg
        self.pages_per_seq = pages_per_seq or (num_pages - 1)
        self.engine = PagedEngine(num_pages - 1, page_size, max_batch,
                                  max_pages_per_seq=self.pages_per_seq)
        self.scratch_page = num_pages - 1  # never handed out by the engine
        self.max_batch = max_batch
        self.page_size = page_size
        self.cache = init_cache(cfg, num_pages, page_size, mode, self.device)
        self.attn_int8 = attn_int8
        self.spec_k = spec_k
        self.spec_proposed = 0  # drafted tokens offered to the verifier
        self.spec_accepted = 0  # drafted tokens accepted
        self.seqs: dict[int, _SeqState] = {}
        self.steps = 0
        self.decode_steps = 0  # single-token decode passes
        self.verify_steps = 0  # multi-token verify passes
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self._stopped: list[int] = []

    def submit(self, seq_id: int, prompt: list[int], max_new_tokens: int,
               stop=()):
        """Queue a request. ``stop``: token ids that end the sequence early
        (kept in the generation, the EOS convention)."""
        self.engine.add_request(seq_id, len(prompt), max_new_tokens)
        self.seqs[seq_id] = _SeqState(prompt=list(prompt), generated=[],
                                      max_new=max_new_tokens,
                                      stop=frozenset(stop),
                                      submit_t=time.perf_counter())

    @property
    def has_work(self) -> bool:
        return self.engine.waiting > 0 or self.engine.running > 0

    def _tensor(self, x, dtype=torch.int64):
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def step(self) -> list[int]:
        """One scheduler + model step; returns sequence ids finished now."""
        batch = self.engine.step()
        if len(batch.ids) == 0:
            return []
        self.steps += 1
        self._stopped = []

        # Prefill newly admitted sequences, and preempted ones the scheduler
        # readmitted (recompute preemption resets them to length == prompt;
        # greedy decoding regenerates the same tokens).
        decode_rows, pending = [], []
        for row, sid in enumerate(batch.ids.tolist()):
            st = self.seqs[sid]
            if st.prefilled and batch.lengths[row] == len(st.prompt):
                st.prefilled = False  # was preempted: its pages are gone
                st.generated = []
            if not st.prefilled:
                logits, self.cache = prefill(
                    self.params, self._tensor(_pad_to_multiple(st.prompt))[None],
                    self.cfg, self.cache, self._tensor(batch.page_tables[row]),
                    prompt_len=len(st.prompt))
                self.prefill_tokens += len(st.prompt)
                pending.append((sid, greedy_token(logits)))
                st.prefilled = True
            else:
                decode_rows.append(row)
        if pending:
            # One device-to-host copy for all first tokens of this step.
            toks = torch.stack([t for _, t in pending]).tolist()
            for (sid, _), tok in zip(pending, toks):
                self._append(sid, int(tok))

        if decode_rows:
            if (self.spec_k > 0 and self.engine.waiting == 0
                    and len(decode_rows) == len(batch.ids)
                    and self.engine.grow_batch(self.spec_k)):
                return self._decode_speculative(batch, decode_rows)
            self._decode_one(batch, decode_rows)
        return self._finish_stamp(self._stopped + self.engine.commit())

    def _finish_stamp(self, sids: list[int]) -> list[int]:
        now = time.perf_counter()
        for sid in sids:
            self.seqs[sid].done_t = now
        return sids

    def _append(self, sid: int, tok: int) -> bool:
        """Record one generated token; finish the sequence on a stop token.

        Returns True when the sequence just stopped: its engine pages are
        freed at once, so callers must write no more tokens or K/V for it.
        """
        st = self.seqs[sid]
        st.generated.append(tok)
        if len(st.generated) == 1:
            st.first_t = time.perf_counter()
        if tok in st.stop:
            self.engine.finish(sid)
            self._stopped.append(sid)
            return True
        return False

    def _gather_batch(self, batch, decode_rows, pad_length: int):
        """Row-gather the decode batch and pad it to ``max_batch``.

        Padding rows are dummies of length ``pad_length`` whose only page is
        the reserved scratch page.
        """
        rows = np.asarray(decode_rows)
        tokens = np.array(
            [self.seqs[batch.ids[r]].generated[-1] for r in decode_rows],
            np.int64)
        lengths = batch.lengths[rows]
        tables = batch.page_tables[rows]
        pad = self.max_batch - len(rows)
        if pad:
            tokens = np.concatenate([tokens, np.zeros(pad, np.int64)])
            lengths = np.concatenate([lengths, np.full(pad, pad_length, np.int32)])
            pad_tables = np.full((pad, tables.shape[1]), -1, np.int32)
            pad_tables[:, 0] = self.scratch_page
            tables = np.concatenate([tables, pad_tables], axis=0)
        return tokens, lengths, tables

    def _decode_speculative(self, batch, decode_rows) -> list[int]:
        """One verify_step scoring spec_k drafted tokens per sequence.

        Each row drafts by prompt lookup; the t = spec_k + 1 inputs [last
        token, draft] go through one multi-token pass, and the draft is
        accepted greedily up to the first token where the model disagrees,
        which contributes the correction (a fully accepted draft gets a
        bonus token from the last row). Every step commits at least one
        token. ``grow_batch`` has reserved the extra slots (all or nothing,
        no preemption); each sequence then commits what it accepted.
        """
        k = self.spec_k
        t = k + 1
        sids = [int(batch.ids[r]) for r in decode_rows]
        drafts = []
        inputs = np.zeros((self.max_batch, t), np.int64)
        draft_lens = np.zeros(self.max_batch, np.int64)
        for i, sid in enumerate(sids):
            st = self.seqs[sid]
            ctx = st.prompt + st.generated
            d = _prompt_lookup_draft(ctx, k)
            drafts.append(d)
            inputs[i, 0] = ctx[-1]
            inputs[i, 1:1 + len(d)] = d
            draft_lens[i] = len(d)
        # Padding rows: t tokens at positions 0..k of the scratch page.
        _, lengths, tables = self._gather_batch(batch, decode_rows, pad_length=1)
        lengths = lengths + k  # the t inputs end at position lengths0 + k - 1
        logits, self.cache = verify_step(
            self.params, self._tensor(inputs), self.cfg, self.cache,
            self._tensor(lengths, torch.int32), self._tensor(tables, torch.int32),
            attn_int8=self.attn_int8)
        self.verify_steps += 1
        toks, n_emit = spec_accept_sample(
            logits, self._tensor(inputs[:, 1:]), self._tensor(draft_lens))
        # One device-to-host copy for the whole batch.
        toks, n_emit = toks.tolist(), n_emit.tolist()

        finished: list[int] = []
        for i, sid in enumerate(sids):
            st = self.seqs[sid]
            out_toks = toks[i][:n_emit[i]]
            self.spec_proposed += len(drafts[i])
            self.spec_accepted += len(out_toks) - 1
            out_toks = out_toks[:st.max_new - len(st.generated)]
            n_commit, stopped = 0, False
            for tok in out_toks:
                n_commit += 1
                self.decode_tokens += 1
                if self._append(sid, int(tok)):
                    stopped = True  # _append recorded it in self._stopped
                    break
            if not stopped and self.engine.commit_n(sid, n_commit):
                finished.append(sid)  # budget reached
        return self._finish_stamp(self._stopped + finished)

    def _decode_one(self, batch, decode_rows):
        """One greedy token for every decoding row."""
        tokens, lengths, tables = self._gather_batch(batch, decode_rows, pad_length=1)
        logits, self.cache = decode_step(
            self.params, self._tensor(tokens), self.cfg, self.cache,
            self._tensor(lengths, torch.int32), self._tensor(tables, torch.int32),
            attn_int8=self.attn_int8)
        sids = [int(batch.ids[r]) for r in decode_rows]
        self.decode_steps += 1
        toks = greedy_token(logits[:len(sids)]).tolist()
        for sid, tok in zip(sids, toks):
            self._append(sid, int(tok))
        self.decode_tokens += len(decode_rows)

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Drive until every submitted request finishes; returns generations."""
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        else:
            raise RuntimeError(f"did not drain within {max_steps} steps")
        return {sid: st.generated for sid, st in self.seqs.items()}

    def throughput(self) -> float:
        """Decode tokens per wall-second for the run this call performs."""
        start_tokens = self.decode_tokens
        t0 = time.perf_counter()
        self.run()
        dt = time.perf_counter() - t0
        return (self.decode_tokens - start_tokens) / dt if dt > 0 else 0.0

    def stats(self) -> dict:
        """Serving counters; ``prefix_hit_pages`` is 0 (no prefix cache
        yet)."""
        return {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "verify_steps": self.verify_steps,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "running": self.engine.running,
            "waiting": self.engine.waiting,
            "free_pages": self.engine.free_pages,
            "preemptions": int(self.engine.preempt_count),
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance_rate": (self.spec_accepted / self.spec_proposed
                                     if self.spec_proposed else 0.0),
            "prefix_hit_pages": 0,
        }
