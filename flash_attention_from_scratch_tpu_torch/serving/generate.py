"""Continuous-batching generation: native scheduler + the port's kernels.

Counterpart of ``flash_attention_from_scratch_tpu/serving/generate.py``
``GenerationServer`` for greedy or sampled (temperature, top-k) decoding
over a dense or quantized (int8, fp8, int4) KV cache; the parameters may
hold quantized weights (``models.llama.quantize_params``), fused
projections (``models.llama.fuse_projections``) or routed experts
(``models.moe``: each decode step routes its whole padded batch
together). Requests enter the native scheduler
(``serving.runtime.PagedEngine``); each step admits what fits,
prefills newly admitted prompts through the flash forward kernel (whole,
in chunks of ``prefill_chunk_tokens`` through
``models.decode.prefill_chunked``, or with ``prefix_cache`` only the
suffix past the pages another prompt published), and advances every
running sequence through the paged decode kernel: one token, ``chunk``
tokens in one ``decode_loop`` while the batch cannot change, or with
``spec_k`` a prompt-lookup draft of up to ``spec_k`` tokens verified in
one multi-token pass (``models.decode.verify_step``). ``attn_int8`` runs
the paged kernel in int8 compute on an int8 cache. With ``lora``
(``models/lora.py``) each request names its adapter (``submit(...,
adapter=i)``; -1 the base model): its prompt's prefill and every decode
step or loop apply each row's own adapter to the shared base weights. The
decode batch is padded to ``max_batch``; padding rows (adapter -1) write
their K/V to a reserved scratch page.

On the card every decode step, verify step and decode loop is a CUDA-graph
replay (``models.step_graphs.StepGraphs``, the counterpart of the JAX
server's jitted steps); on the CPU (``device="cpu"``) they run eagerly.

With ``mesh`` (a tp mesh, ``parallel.mesh.make_mesh(1, tp)``) the server
runs SPMD, as the JAX one does: every rank builds it on the same global
parameters (each keeps its shard) and submits the same requests, and the
deterministic scheduler keeps the ranks in step; each rank's cache holds
its KV heads, and every rank picks the same tokens from the gathered
logits. Under a mesh the steps run eagerly: a CUDA graph cannot capture a
gloo collective (NCCL collectives in the step graphs are ROADMAP work).

Sampled tokens are keyed on (seed, sequence id, position = the token's
index in the generation), as in the JAX server: a preempted sequence
replays its draws, and a token does not depend on the path that drew it
(the prefill's pick, a step, a loop of n steps, a padded batch, or a
speculative step, whose acceptance is coupled to the same draw). The noise
is ``models.decode.sample_noise``: the JAX server's distributions, not
its ``jax.random`` draws.

Token bookkeeping matches the scheduler's accounting: after ``step()`` a
sequence's length counts its prompt plus committed tokens; the token
generated this step writes K/V at position ``length - 1``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time

import numpy as np
import torch

from ..models.decode import (
    _step, check_mesh, check_no_sinks, decode_loop, init_cache, pick_keyed, prefill,
    prefill_chunked, row_keys,
)
from ..models.llama import LlamaConfig
from ..models.lora import n_adapters
from ..models.step_graphs import StepGraphs
from ..ops import _build
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, shard_params
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


def _page_hashes(prompt: list[int], page_size: int) -> list[int]:
    """Chained 64-bit content hashes of the prompt's full pages (the JAX
    package's): hash i covers tokens [0, (i + 1) * page_size), each 8-byte
    blake2b digest of the int64 tokens feeding the next, so one page's
    match implies the whole prefix matches (the key scheme of
    ``fa_engine_add_request_cached``)."""
    out: list[int] = []
    digest = b""
    for i in range(len(prompt) // page_size):
        blk = np.asarray(prompt[i * page_size:(i + 1) * page_size], np.int64).tobytes()
        digest = hashlib.blake2b(digest + blk, digest_size=8).digest()
        out.append(int.from_bytes(digest, "little"))
    return out


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
    key: int = 0  # the sampling key of (seed, sequence id): decode.row_keys
    adapter: int = -1  # LoRA adapter id (-1: the base model)
    # Wall clock: submit -> first token -> finished.
    submit_t: float = 0.0
    first_t: float = 0.0
    done_t: float = 0.0


class GenerationServer:
    """Continuous-batching generation over a paged KV cache.

    ``num_pages`` is the total pool; one page is reserved as the scratch
    target for decode-batch padding rows, the rest belong to the scheduler.
    ``params`` must live on ``device`` (default: the card; without one the
    constructor raises). ``mode`` is the KV cache format: "dense", "int8",
    "fp8" or "int4". ``spec_k`` (1 to page_size - 1) drafts that many tokens
    by prompt lookup and verifies them in one pass whenever the whole batch
    is decoding and nothing waits; ``attn_int8`` (int8 cache only) runs the
    paged kernel's int8 compute. ``chunk`` (1 to page_size) decodes up to
    that many tokens per step in one ``decode_loop`` while the batch
    cannot change (exclusive with ``spec_k``); ``prefill_chunk_tokens`` (a
    multiple of 128 and of page_size) prefills prompts in chunks of that
    many tokens. ``temperature > 0`` samples (``top_k`` filters first;
    greedy at 0), keyed on ``seed``; on the card the pick runs inside each
    step's, loop's and verify step's graph. ``prefix_cache`` shares full
    prompt pages by content hash (``_page_hashes``): a prompt prefills
    only past the pages it found published, in chunks of
    ``prefill_chunk_tokens`` or lcm(128, page_size), and publishes its own
    after. ``lora``: a stack of LoRA adapters (``models.lora``), one
    chosen a request by ``submit(..., adapter=)``; with ``spec_k``,
    ``prefill_chunk_tokens``, ``prefix_cache`` or ``mesh`` it raises
    ``ValueError``, as in the JAX server (chunked prefill takes no
    adapters). ``mesh``: tensor-parallel serving (see the module
    docstring); ``params`` are the global tree, sharded here
    (``parallel.mesh.shard_params``), and the server runs on the mesh's
    device. MoE params under a mesh raise ``NotImplementedError``. A config
    with attention sinks, and the checks of the JAX server on ``chunk``,
    ``spec_k``, ``prefill_chunk_tokens`` and ``prefix_cache`` with
    ``mesh``, on tp dividing ``n_kv_heads`` and on dp = 1, raise
    ``ValueError``, and so does a config whose type the decode kernels
    (K4/K5) take on no library of the card (fp32: ROADMAP item 4c-2), at
    construction. On the card without a mesh ``graphs`` is the server's
    :class:`~..models.step_graphs.StepGraphs` (None on the CPU and under a
    mesh).
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
        if prefill_chunk_tokens and (prefill_chunk_tokens % 128
                                     or prefill_chunk_tokens % page_size):
            raise ValueError(
                f"prefill_chunk_tokens ({prefill_chunk_tokens}) must be a "
                f"multiple of 128 and of page_size ({page_size})")
        if prefill_chunk_tokens and mesh is not None:
            raise ValueError("prefill_chunk_tokens + mesh not supported yet "
                             "(chunked prefill is single-chip)")
        if spec_k:
            if chunk > 1:
                raise ValueError("spec_k and chunk>1 are exclusive decode strategies")
            if not 1 <= spec_k + 1 <= page_size:
                # Padding rows park their t = spec_k + 1 tokens in the single
                # scratch page.
                raise ValueError(f"spec_k must be in [1, page_size - 1]; got {spec_k}")
        if prefix_cache and mesh is not None:
            raise ValueError("prefix_cache + mesh not supported yet "
                             "(suffix prefill is single-chip chunked)")
        if lora is not None and (spec_k or prefill_chunk_tokens or prefix_cache
                                 or mesh is not None):
            # prefix_cache and prefill_chunk_tokens prefill through
            # prefill_chunked, which takes no adapters: the prompt's K/V
            # would be the base model's (and the prefix cache would publish
            # them to other requests).
            raise ValueError("multi-LoRA serving supports stepwise and chunked decode "
                             "only (no spec_k/chunked-prefill/prefix_cache/mesh)")
        if mesh is not None:
            check_mesh(params, mesh)
            tp = mesh.size(MODEL_AXIS)
            if cfg.n_kv_heads % tp:
                raise ValueError(
                    f"tensor-parallel serving shards KV heads over {MODEL_AXIS}={tp}, but "
                    f"n_kv_heads={cfg.n_kv_heads} is not divisible")
            if mesh.size(DATA_AXIS) > 1 or SEQ_AXIS in mesh.axis_names:
                raise ValueError(f"serving mesh must have {DATA_AXIS}=1 and no "
                                 f"{SEQ_AXIS} axis (prefill is single-prompt); got "
                                 f"{mesh.shape}")
            params = shard_params(params, mesh)
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type == "cuda":  # decode's K4/K5 library, before any work
            _build.typed_source("paged_attention.cu", cfg.dtype.torch_dtype,
                                "GenerationServer's decode (K4/K5)")
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
        self.cache = init_cache(cfg, num_pages, page_size, mode, self.device, mesh)
        self.attn_int8 = attn_int8
        self.temperature, self.top_k, self.seed = temperature, top_k, seed
        self.lora = lora
        self.n_adapters = n_adapters(lora)
        self.graphs = (StepGraphs(params, cfg, self.cache, attn_int8=attn_int8,
                                  temperature=temperature, top_k=top_k, lora=lora)
                       if self.device.type == "cuda" and mesh is None else None)
        self.chunk = chunk
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.spec_k = spec_k
        self.prefix_cache = prefix_cache
        # Suffix prefill runs in chunks aligned to the flash tile and to the
        # page size, so cached page boundaries are chunk boundaries.
        self._pc_chunk = prefill_chunk_tokens or math.lcm(128, page_size)
        self.spec_proposed = 0  # drafted tokens offered to the verifier
        self.spec_accepted = 0  # drafted tokens accepted
        self.seqs: dict[int, _SeqState] = {}
        self.steps = 0
        self.decode_steps = 0  # single-token decode passes, loops' included
        self.decode_loops = 0  # decode_loop calls (chunk > 1)
        self.verify_steps = 0  # multi-token verify passes
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self._stopped: list[int] = []

    def submit(self, seq_id: int, prompt: list[int], max_new_tokens: int,
               stop=(), adapter: int = -1):
        """Queue a request. ``stop``: token ids that end the sequence early
        (kept in the generation, the EOS convention). ``adapter``: the LoRA
        adapter that serves it (-1: the base model); an adapter on a server
        without ``lora``, or past its last adapter, raises ``ValueError``
        (the gather clamps ids, so a typo would serve another adapter)."""
        if adapter >= 0 and self.lora is None:
            raise ValueError("server built without lora adapters")
        if self.lora is not None and adapter >= self.n_adapters:
            raise ValueError(f"adapter {adapter} out of range (n={self.n_adapters})")
        if self.prefix_cache:
            self.engine.add_request_cached(seq_id, len(prompt), max_new_tokens,
                                           _page_hashes(prompt, self.page_size))
        else:
            self.engine.add_request(seq_id, len(prompt), max_new_tokens)
        self.seqs[seq_id] = _SeqState(prompt=list(prompt), generated=[],
                                      max_new=max_new_tokens,
                                      stop=frozenset(stop),
                                      key=int(row_keys(self.seed, seq_id)),
                                      adapter=adapter, submit_t=time.perf_counter())

    @property
    def has_work(self) -> bool:
        return self.engine.waiting > 0 or self.engine.running > 0

    def _tensor(self, x, dtype=torch.int64):
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def _keys(self, sids: list[int]):
        """(row keys, positions) int64 on the CPU of ``sids``, padded to
        ``max_batch`` rows (key and position 0): each sequence's key under
        the seed and its next token's index in its generation."""
        pad = self.max_batch - len(sids)
        keys = torch.tensor([self.seqs[s].key for s in sids] + [0] * pad,
                            dtype=torch.int64)
        pos = torch.tensor([len(self.seqs[s].generated) for s in sids] + [0] * pad,
                           dtype=torch.int64)
        return keys, pos

    def _adapter_ids(self, sids: list[int]):
        """Each row's adapter id, int64 on the CPU, padded to ``max_batch``
        rows with -1; None without ``lora``."""
        if self.lora is None:
            return None
        pad = self.max_batch - len(sids)
        return torch.tensor([self.seqs[s].adapter for s in sids] + [-1] * pad,
                            dtype=torch.int64)

    def step(self) -> list[int]:
        """One scheduler + model step; returns sequence ids finished now."""
        batch = self.engine.step()
        if len(batch.ids) == 0:
            return []
        self.steps += 1
        self._stopped = []

        # Prefill newly admitted sequences, and preempted ones the scheduler
        # readmitted (recompute preemption resets them to length == prompt;
        # greedy and keyed sampling regenerate the same tokens).
        decode_rows, pending = [], []
        for row, sid in enumerate(batch.ids.tolist()):
            st = self.seqs[sid]
            if st.prefilled and batch.lengths[row] == len(st.prompt):
                st.prefilled = False  # was preempted: its pages are gone
                st.generated = []
            if not st.prefilled:
                tokens = self._tensor(_pad_to_multiple(st.prompt))[None]
                table = self._tensor(batch.page_tables[row])
                if self.prefix_cache:
                    # Skip the chunks the cached pages cover; their K/V were
                    # written by the prompt that published them.
                    chunk = self._pc_chunk
                    start = min(self.engine.cached_pages(sid) * self.page_size,
                                (len(st.prompt) - 1) // chunk * chunk)
                    start -= start % chunk
                    logits, self.cache = prefill_chunked(
                        self.params, tokens, self.cfg, self.cache, table,
                        prompt_len=len(st.prompt), chunk_tokens=chunk,
                        start_tokens=start)
                    self.engine.publish(sid)
                elif self.prefill_chunk_tokens:
                    logits, self.cache = prefill_chunked(
                        self.params, tokens, self.cfg, self.cache, table,
                        prompt_len=len(st.prompt),
                        chunk_tokens=self.prefill_chunk_tokens)
                else:
                    # The id made on the device, as the key below.
                    ids = (None if self.lora is None else torch.full(
                        (1,), st.adapter, dtype=torch.int64, device=self.device))
                    logits, self.cache = prefill(
                        self.params, tokens, self.cfg, self.cache, table,
                        prompt_len=len(st.prompt), lora=self.lora, adapter_ids=ids,
                        mesh=self.mesh)
                self.prefill_tokens += len(st.prompt)
                # Key and position made on the device: a copy from the host
                # would wait for this prefill before the next one launches.
                key, pos = (torch.full((1,), x, dtype=torch.int64, device=self.device)
                            for x in (st.key, len(st.generated)))
                tok, _ = pick_keyed(logits[None, None], tokens[:, :0], torch.zeros_like(pos),
                                    key, pos, self.temperature, self.top_k)
                pending.append((sid, tok[0, 0]))
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
            n = self._chunk_len(batch, decode_rows)
            if n > 1:
                batch = self._advance_chunk(batch, n)
                self._decode_chunk(batch, decode_rows, n)
            else:
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

    def _chunk_len(self, batch, decode_rows) -> int:
        """Tokens to decode this step while the batch provably cannot
        change: nothing waits, every row is past prefill, no row reaches
        its budget inside the chunk, and the free pages cover the chunk's
        growth (no preemption). Rounded down to a power of two, so that
        the loops captured are {2, 4, 8, ...}; 1 otherwise."""
        if (self.chunk <= 1 or self.engine.waiting > 0
                or len(decode_rows) != len(batch.ids)):
            return 1
        n = min([self.chunk] + [
            self.seqs[int(batch.ids[r])].max_new
            - len(self.seqs[int(batch.ids[r])].generated) for r in decode_rows])
        if n <= 1:
            return 1
        n = 1 << (n.bit_length() - 1)
        ps = self.page_size
        # step() allocated through lengths + 1; the n - 1 advance steps
        # extend coverage to lengths + n.
        crossings = sum(-(-(int(batch.lengths[r]) + n) // ps)
                        - -(-(int(batch.lengths[r]) + 1) // ps)
                        for r in decode_rows)
        return n if crossings <= self.engine.free_pages else 1

    def _advance_chunk(self, batch, n: int):
        """Run the scheduler n - 1 tokens ahead; returns the last batch,
        whose page tables cover every slot the chunk writes. No sequence
        can finish and none can join inside the chunk (``_chunk_len``)."""
        ids0 = batch.ids.copy()
        for _ in range(n - 1):
            if self.engine.commit():
                raise RuntimeError("a sequence finished inside a decode chunk")
            batch = self.engine.step()
            if not np.array_equal(batch.ids, ids0):
                raise RuntimeError("the batch changed inside a decode chunk")
        self.steps += n - 1
        return batch

    def _gather_batch(self, batch, decode_rows, pad_length: int,
                      length_offset: int = 0):
        """Row-gather the decode batch and pad it to ``max_batch``.

        Padding rows are dummies of length ``pad_length`` whose only page is
        the reserved scratch page (0 for a chunk, whose padding rows grow
        through it: chunk <= page_size). ``length_offset`` is added to the
        real rows' lengths. Returns numpy (tokens, lengths int32, tables
        int32).
        """
        rows = np.asarray(decode_rows)
        tokens = np.array(
            [self.seqs[batch.ids[r]].generated[-1] for r in decode_rows],
            np.int64)
        lengths = batch.lengths[rows] + np.int32(length_offset)
        tables = batch.page_tables[rows]
        pad = self.max_batch - len(rows)
        if pad:
            tokens = np.concatenate([tokens, np.zeros(pad, np.int64)])
            lengths = np.concatenate([lengths, np.full(pad, pad_length, np.int32)])
            pad_tables = np.full((pad, tables.shape[1]), -1, np.int32)
            pad_tables[:, 0] = self.scratch_page
            tables = np.concatenate([tables, pad_tables], axis=0)
        return tokens, lengths, tables

    def _pick_step(self, sids, tokens, lengths, tables, draft_lens):
        """A decode (t = 1) or verify step on numpy inputs of ``max_batch``
        rows (tokens (max_batch, t), the drafts ``tokens[:, 1:]``) with its
        pick (``pick_keyed``: row j of each sequence at position
        len(generated) + j): one graph replay on the card, the pick inside;
        eager on the CPU. Returns (tokens (max_batch, t), n_emit)."""
        keys, pos0 = self._keys(sids)
        ids = self._adapter_ids(sids)
        tokens, lengths, tables, draft_lens = (
            torch.from_numpy(a) for a in (tokens, lengths, tables, draft_lens))
        if self.graphs is not None:
            return self.graphs.pick_step(tokens, lengths, tables, draft_lens, keys, pos0,
                                         ids)
        # Eager: on the CPU, or on the card under a mesh.
        tokens, lengths, tables, keys, pos0 = (
            a.to(self.device) for a in (tokens, lengths, tables, keys, pos0))
        logits, self.cache = _step(self.params, tokens, self.cfg, self.cache, lengths,
                                   tables, self.lora, self.mesh, self.attn_int8, ids)
        return pick_keyed(logits, tokens[:, 1:], draft_lens, keys, pos0,
                          self.temperature, self.top_k)

    def _decode_speculative(self, batch, decode_rows) -> list[int]:
        """One verify_step scoring spec_k drafted tokens per sequence.

        Each row drafts by prompt lookup; the t = spec_k + 1 inputs [last
        token, draft] go through one multi-token pass, and the draft is
        accepted up to the first token the model refuses (greedy: where it
        disagrees), which contributes the correction (a fully accepted
        draft gets a bonus token from the last row). Sampled acceptance
        draws each row j at the position its token takes, so a step emits
        the tokens plain sampling would (``pick_keyed``); on the card it
        runs inside the verify graph (``_pick_step``). Every step
        commits at least one token. ``grow_batch`` has reserved the extra
        slots (all or nothing, no preemption); each sequence then commits
        what it accepted.
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
        lengths = lengths + np.int32(k)  # the t inputs end at position lengths0 + k - 1
        self.verify_steps += 1
        toks, n_emit = self._pick_step(sids, inputs, lengths, tables, draft_lens)
        # One device-to-host copy each for the whole batch.
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

    def _decode_chunk(self, batch, decode_rows, n: int):
        """One ``decode_loop`` of n tokens for every row (greedy, or sampled
        at positions len(generated) + i): a graph replay on the card, eager
        on the CPU. Tokens after a row's stop token are dropped."""
        # decode_loop takes committed lengths; the scheduler has already
        # allocated all n new slots, so batch.lengths is n ahead.
        tokens, lengths, tables = self._gather_batch(
            batch, decode_rows, pad_length=0, length_offset=-n)
        tokens, lengths, tables = (torch.from_numpy(a) for a in (tokens, lengths, tables))
        sids = [int(batch.ids[r]) for r in decode_rows]
        keys, pos0 = self._keys(sids)
        ids = self._adapter_ids(sids)
        if self.graphs is not None:
            out, _ = self.graphs.decode_loop(tokens, lengths, tables, n, row_keys=keys,
                                             pos0=pos0, adapter_ids=ids)
        else:
            tokens, lengths, tables, keys, pos0 = (
                a.to(self.device) for a in (tokens, lengths, tables, keys, pos0))
            out, self.cache, _ = decode_loop(
                self.params, tokens, self.cfg, self.cache, lengths, tables, n,
                row_keys=keys, pos0=pos0, temperature=self.temperature,
                top_k=self.top_k, mesh=self.mesh, attn_int8=self.attn_int8, lora=self.lora,
                adapter_ids=ids)
        self.decode_loops += 1
        self.decode_steps += n
        out = out[:len(decode_rows)].tolist()  # one device-to-host copy
        for i, r in enumerate(decode_rows):
            sid = int(batch.ids[r])
            for tok in out[i]:
                self.decode_tokens += 1
                if self._append(sid, int(tok)):
                    break

    def _decode_one(self, batch, decode_rows):
        """One token for every decoding row (a ``_pick_step`` of t = 1)."""
        tokens, lengths, tables = self._gather_batch(batch, decode_rows, pad_length=1)
        sids = [int(batch.ids[r]) for r in decode_rows]
        self.decode_steps += 1
        toks, _ = self._pick_step(sids, tokens[:, None], lengths, tables,
                                  np.zeros(self.max_batch, np.int64))
        toks = toks[:len(sids), 0].tolist()  # one device-to-host copy
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
        """Serving counters; ``prefix_hit_pages`` counts the prompt pages
        served from the prefix cache (0 without it)."""
        return {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "decode_loops": self.decode_loops,
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
            "prefix_hit_pages": (int(self.engine.prefix_hits)
                                 if self.prefix_cache else 0),
        }
