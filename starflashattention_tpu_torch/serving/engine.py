"""Continuous-batching engines: contiguous-cache and paged-cache serving —
twin of the JAX ``serving/engine.py``.

Loop shape (host): admit -> masked (or chunked) prefill of new slots -> one
fixed-size decode round of ``steps_per_round`` steps with the tokens kept
on the device -> ONE readback -> record / retire -> repeat.

- :class:`Engine`: contiguous per-slot KV windows (``cache/contiguous.py``).
- :class:`PagedEngine`: paged pools + per-sequence page tables
  (``cache/paged.py``). Pages are allocated at admission, grown ahead of
  each decode round and freed at retirement; under pool exhaustion the
  youngest running request is PREEMPTED (pages freed, request requeued) and
  later resumes by re-prefilling ``prompt + output`` (greedy decoding is
  deterministic, and sampled draws are keyed on (seed, position)). With
  ``prefix_cache=True`` full prompt pages are shared between requests
  (``serving/prefix_cache.py``). The allocator is the C++ page pool
  (``utils/native.py``) when it builds, else its Python twin.

With ``spec_decode=k`` the contiguous :class:`Engine` decodes
speculatively: each round runs ``steps_per_round`` verify steps that
propose k draft tokens a slot, from prompt lookup in the slot's token
history (``spec_ngram``) or from a small ``draft_model=(params, cfg)``
whose cache advances beside the target's, and emit 1 to k+1 tokens a slot
(``models/llama.spec_decode_multi(_draft)``). Greedy only.

Both record serving metrics (TTFT, decode throughput, rounds, preemptions,
speculative steps) in :class:`EngineStats`.

With ``mesh`` (a ``parallel.mesh.Mesh`` with a ``model`` axis and
optionally a ``data`` axis, JAX engine.py:94-130, :935-960) both engines
serve tensor- and data-parallel: one process a rank, each running the
whole engine. The params are sharded at construction
(``parallel.tp.shard_params``: full params in, this rank's shard kept), the
cache holds this rank's KV heads of its data shard's slots, and every
prefill and decode round is a ``parallel.tp`` builder, which returns the
tokens (and logits) of every data shard to every rank. So each rank's
scheduler sees the same tokens and makes the same decisions, and every
rank's streams are equal bit for bit. ``num_slots`` must divide over the
data axis; slot ``s`` lives on data shard ``s // (num_slots / data)``.
:class:`PagedEngine` keeps one page allocator per data shard, whose page
ids are local to that shard's pool partition, and preempts within the
shard that ran out.

Multi-LoRA serving (S-LoRA style, JAX engine.py:217-237): with
``lora_adapters`` (a list of trained adapter trees, ``models/lora``) both
engines hold the N adapters stacked on their device (under ``mesh`` each
rank its shard, ``parallel.tp.shard_lora``), and each request picks one by
``Request.adapter`` (or ``generate(..., adapters=)``), None for the base
model; requests on different adapters share every batch. Each prefill and
decode call takes the (B, N) one-hot of the slots' adapters. A preempted
request resumes on its adapter, and the paged engine's prefix cache matches
pages only within one adapter (``serving/prefix_cache.py``).
``spec_decode`` with adapters raises, as in JAX.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: ``run_resilient`` / ``recover_device_state`` (item 17). As in JAX, an
MLA model (DeepSeek-V2) takes none of ``mesh``, ``spec_decode`` and
``lora_adapters``, and ``prefix_cache`` does not compose with ``mesh``.

Sliding-window models on :class:`PagedEngine` keep a rolling buffer (JAX
engine.py:985-1000, :1255-1305): before each decode round, the private
pages that lie wholly below every future page walk are freed and their
table entries set to the null page 0, and with attention sinks the pages
that back the sink walk blocks are pinned instead (owned by the engine,
kept in the table for good). Models whose window differs from layer to
layer (``sliding_window_pattern != 1``) reclaim nothing: their full layers
read every page.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from starflashattention_tpu_torch.cache import contiguous, paged
from starflashattention_tpu_torch.core import sampling as core_sampling
from starflashattention_tpu_torch.models import llama
from starflashattention_tpu_torch.models import lora as lora_lib
from starflashattention_tpu_torch.runtime.params import ModelConfig
from starflashattention_tpu_torch.serving.scheduler import Request, Scheduler
from starflashattention_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class EngineStats:
    """Serving counters (host-side, updated once per round — not hot-path)."""

    ttfts_s: list[float] = dataclasses.field(default_factory=list)
    decode_tokens: int = 0
    decode_seconds: float = 0.0
    prefill_rounds: int = 0
    decode_rounds: int = 0
    preemptions: int = 0
    finished: int = 0
    # prefix cache (paged engine, serving/prefix_cache.py)
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    # speculative decoding: per-slot verify steps that kept a token;
    # decode_tokens / spec_steps - 1 = mean accepted drafts per step
    spec_steps: int = 0

    def p50_ttft_ms(self) -> float:
        return float(np.median(self.ttfts_s) * 1e3) if self.ttfts_s else 0.0

    def mean_ttft_ms(self) -> float:
        return float(np.mean(self.ttfts_s) * 1e3) if self.ttfts_s else 0.0

    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_seconds if self.decode_seconds else 0.0

    def summary(self) -> dict:
        return {
            "p50_ttft_ms": round(self.p50_ttft_ms(), 2),
            "mean_ttft_ms": round(self.mean_ttft_ms(), 2),
            "decode_tokens_per_s": round(self.decode_tokens_per_s(), 1),
            "decode_tokens": self.decode_tokens,
            "prefill_rounds": self.prefill_rounds,
            "decode_rounds": self.decode_rounds,
            "preemptions": self.preemptions,
            "finished": self.finished,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "spec_accept_per_step": (round(self.decode_tokens / self.spec_steps - 1.0, 3)
                                     if self.spec_steps else 0.0),
        }


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class Engine:
    """Contiguous-cache continuous-batching engine on ``device`` (default
    ``cuda``; ``params`` must already live there)."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        num_slots: int = 8,
        steps_per_round: int = 8,
        prefill_pad: int = 64,
        prefill_chunk: int | None = None,
        mesh=None,
        enable_sampling: bool = False,
        return_logprobs: bool = False,
        spec_decode: int | None = None,
        spec_ngram: int = 4,
        draft_model: tuple | None = None,
        debug_validate: bool = False,
        lora_adapters: list | None = None,
        topk_logprobs: int = 0,
        device: torch.device | str | None = None,
    ):
        if cfg.mla and (mesh is not None or spec_decode is not None or lora_adapters is not None):
            # JAX engine.py:125-132 refuses these too
            raise NotImplementedError(
                "MLA serves on the single-device contiguous and paged engines for now: no mesh, "
                "spec_decode or lora_adapters with it (ROADMAP Queue 2, K1 verify at D 640)")
        llama.check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the engine runs on "
                             f"{self.device}")
        # Speculative decoding (JAX engine.py:136-195): the acceptance rule is
        # exact-argmax-match, so greedy only, and the verify step is the
        # single-split kernel, so the plain path must be too.
        self.spec_decode = spec_decode
        self.spec_ngram = spec_ngram
        self.draft_model = draft_model
        if draft_model is not None:
            if spec_decode is None:
                raise ValueError("draft_model requires spec_decode=<num drafts>")
            dparams, dcfg = draft_model
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab {dcfg.vocab_size} != target vocab {cfg.vocab_size} "
                                 "(argmax token ids must be comparable)")
            if dcfg.max_seq_len < cfg.max_seq_len:
                raise ValueError("draft max_seq_len must cover the target's (the caches advance "
                                 "in lockstep)")
            llama.check_supported(dcfg)
            if dparams["embed"].device.type != self.device.type:
                raise ValueError(f"draft params live on {dparams['embed'].device}, the engine runs "
                                 f"on {self.device}")
        if spec_decode is not None:
            if enable_sampling or return_logprobs:
                raise ValueError("spec_decode is greedy-only: it composes with neither "
                                 "enable_sampling nor return_logprobs")
            if cfg.num_splits != 1:
                raise ValueError("spec_decode requires cfg.num_splits == 1: verify and plain decode "
                                 "must use the same (fused single-split) kernel for the accepted "
                                 "stream to be bit-identical")
            if topk_logprobs:
                raise ValueError("topk_logprobs does not compose with spec_decode")
        # Multi-LoRA serving: the N adapters stacked once on the engine's
        # device; each slot's adapter id (-1: the base model) picks its row
        # of the one-hot selector every prefill and decode call takes.
        self.lora = None
        self._n_adapters = 0
        if lora_adapters is not None:
            if spec_decode is not None:
                raise NotImplementedError("multi-LoRA does not compose with spec_decode (the verify program has "
                                          "no adapter operands)")
            self.lora = lora_lib.stack_adapters(lora_adapters, device=self.device)
            self._n_adapters = lora_lib.num_adapters(self.lora)
        self._slot_adapter = np.full((num_slots,), -1, np.int32)
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.steps_per_round = steps_per_round
        self.prefill_pad = prefill_pad
        # Chunked prefill: admitted prompts are ingested in fixed
        # (num_slots, prefill_chunk) slices, so a long prompt cannot
        # monopolize a round. Output-identical to whole-prompt prefill.
        self.prefill_chunk = prefill_chunk
        self.enable_sampling = enable_sampling
        self._slot_sampling = [core_sampling.GREEDY] * num_slots
        self.return_logprobs = return_logprobs
        self._last_logprobs = None  # (B, n) host array of the latest round
        self.topk_logprobs = int(topk_logprobs)
        self._last_topk = None  # ((B, n, K) f32, (B, n, K) i32) host arrays
        self.debug_validate = debug_validate
        self.mesh = mesh
        # Rounds are fixed-size; the slack reserves cache room for the final
        # round's discarded overshoot tokens (a spec round appends up to
        # steps * (k+1) rows a slot).
        round_append = steps_per_round * (1 if spec_decode is None else spec_decode + 1)
        self.sched = Scheduler(num_slots, cfg.max_seq_len, capacity_slack=round_append - 1)
        self.cos, self.sin = llama.rope_tables(cfg, device=self.device)
        self.pending_tok = torch.zeros((num_slots,), dtype=torch.int32, device=self.device)
        # token history for prompt-lookup drafting: prompts written at
        # admission, generated tokens by the spec rounds themselves
        self.history = (torch.zeros((num_slots, cfg.max_seq_len), dtype=torch.int32, device=self.device)
                        if spec_decode is not None and draft_model is None else None)
        self.stats = EngineStats()
        self._submit_time: dict[int, float] = {}
        self._first_token_seen: set[int] = set()
        # Host mirror of each live slot's cache length (set at admission,
        # advanced per round): feeds _round_len_hint.
        self._slot_len = np.zeros((num_slots,), np.int64)
        if mesh is not None:
            self.params = self._shard(params)
        self.cache = self._init_cache()
        self.draft_cache = None
        if draft_model is not None:
            self.draft_params, self.draft_cfg = draft_model  # replicated: whole on every rank
            self.dcos, self.dsin = llama.rope_tables(self.draft_cfg, device=self.device)
            self.draft_cache = self._init_draft_cache()

    # -- tensor + data parallelism (JAX engine.py:283-338) ----------------------

    def _shard(self, params):
        """This rank's params, after building the sharded round functions."""
        from starflashattention_tpu_torch.parallel import tp

        data = self.mesh.axes.get(tp.DATA)
        if data is not None and self.num_slots % data.size:
            raise ValueError(f"num_slots {self.num_slots} not divisible by data axis {data.size}")
        self._build_sharded_fns(tp)
        if self.lora is not None:
            # b column-permuted and sharded like the weight it adapts, a row-sharded (tp.shard_lora)
            self.lora = tp.shard_lora(self.lora, self.mesh, self.cfg)
        return tp.shard_params(params, self.mesh, self.cfg)

    def _build_sharded_fns(self, tp) -> None:
        if self.spec_decode is not None and self.draft_model is not None:
            # the draft runs whole on every rank (tp.make_tp_spec_decode_multi_draft)
            self._tp_spec_decode_draft = tp.make_tp_spec_decode_multi_draft(
                self.mesh, self.cfg, self.draft_model[1], self.steps_per_round, num_draft=self.spec_decode)
            self._tp_draft_prefill = tp.make_tp_draft_prefill_serving(self.mesh, self.draft_model[1])
        elif self.spec_decode is not None:
            self._tp_spec_decode = tp.make_tp_spec_decode_multi(
                self.mesh, self.cfg, self.steps_per_round, num_draft=self.spec_decode, ngram=self.spec_ngram)
        self._tp_decode_multi = tp.make_tp_decode_multi(
            self.mesh, self.cfg, self.steps_per_round, sampling=self.enable_sampling,
            with_logprobs=self.return_logprobs, topk_logprobs=self.topk_logprobs, lora_stack=self.lora)
        self._tp_prefill = tp.make_tp_prefill_serving(self.mesh, self.cfg, lora_stack=self.lora)

    # -- cache-backend hooks (overridden by PagedEngine) ----------------------

    def _init_cache(self):
        """The cache of every slot, or under ``mesh`` this rank's shard of it."""
        hkv, d = self.cfg.kv_cache_dims()
        cache = contiguous.init_cache(
            self.cfg.num_layers, self.num_slots, hkv, self.cfg.max_seq_len, d,
            dtype=llama.torch_dtype(self.cfg.dtype), quant_mode=self.cfg.quant_mode,
            calibration_scale=self.cfg.kv_calibration_scale, device=self.device,
        )
        if self.mesh is None:
            return cache
        from starflashattention_tpu_torch.parallel import tp

        return tp.shard_cache(cache, self.mesh)

    def _init_draft_cache(self):
        """The draft model's cache: the target's slots and capacity, since
        the two advance in lockstep (under ``mesh`` this rank's slots)."""
        d = self.draft_cfg
        cache = contiguous.init_cache(
            d.num_layers, self.num_slots, d.num_kv_heads, self.cfg.max_seq_len, d.head_dim,
            dtype=llama.torch_dtype(d.dtype), quant_mode=d.quant_mode,
            calibration_scale=d.kv_calibration_scale, device=self.device,
        )
        if self.mesh is None:
            return cache
        from starflashattention_tpu_torch.parallel import tp

        return tp.shard_draft_cache(cache, self.mesh)

    def _prepare_admit(self, admitted: list[tuple[int, Request]]) -> list[tuple[int, Request]]:
        """Reserve backend capacity for admitted requests; may trim the list
        (rejected entries must be returned to the scheduler by the override)."""
        return admitted

    def _admission_offsets(self, texts) -> np.ndarray:
        """Per-slot count of tokens ALREADY in the cache for each admitted
        text (prefix-cache hits, paged backend). Base engine: always 0."""
        return np.zeros((self.num_slots,), np.int32)

    def _after_prefill(self, texts) -> None:
        """Backend hook: admitted prompts are fully ingested."""

    def _before_decode(self, active: np.ndarray) -> np.ndarray:
        """Ensure backend capacity for one decode round; returns the possibly
        reduced active mask (the paged backend may preempt)."""
        return active

    def _on_retired(self, slot: int) -> None:
        """Backend hook: release per-slot resources."""

    def _prefill_call(self, toks, new_lengths, admit_mask, reset_mask, prefix_len=0):
        # the contiguous prefill attends the whole cache table; prefix_len
        # matters to the paged backend only
        if self.mesh is not None:
            logits, self.cache = self._tp_prefill(self.params, self.cache, toks, new_lengths, admit_mask,
                                                  reset_mask, self.cos, self.sin, *self._lora_args())
            if self.draft_cache is not None:
                _, self.draft_cache = self._tp_draft_prefill(self.draft_params, self.draft_cache, toks,
                                                             new_lengths, admit_mask, reset_mask, self.dcos,
                                                             self.dsin)
            return logits
        logits, self.cache = llama.prefill_serving(
            self.params, self.cache, toks, new_lengths, admit_mask, reset_mask,
            self.cos, self.sin, self.cfg, lora=self.lora, lora_sel=self._lora_sel(),
        )
        if self.draft_cache is not None:
            # the draft ingests the same windows; only its cache matters
            llama.prefill_serving(self.draft_params, self.draft_cache, toks, new_lengths, admit_mask,
                                  reset_mask, self.dcos, self.dsin, self.draft_cfg)
        return logits

    def _decode_call(self, active, n, max_len_hint=None):
        if self.mesh is not None:
            return self._unpack_decode(self._tp_decode_call(active))
        out = llama.decode_multi(
            self.params, self.cache, self.pending_tok, self.cos, self.sin, active, self.cfg, n,
            sampling=self._sampling_state(), with_logprobs=self.return_logprobs,
            topk_logprobs=self.topk_logprobs, max_len_hint=max_len_hint,
            lora=self.lora, lora_sel=self._lora_sel(),
        )
        return self._unpack_decode(out)

    def _tp_decode_call(self, active):
        args = (self.params, self.cache, self.pending_tok, self.cos, self.sin, active)
        if self.enable_sampling:
            args = args + (self._sampling_state(),)
        return self._tp_decode_multi(*args, *self._lora_args())

    # -- multi-LoRA (JAX engine.py:425-432) --------------------------------------

    def _lora_sel(self) -> torch.Tensor | None:
        """(B, N) one-hot of the slots' adapters (a zero row: the base
        model), built on the host and copied once; None without adapters."""
        if self.lora is None:
            return None
        return lora_lib.adapter_onehot(self._slot_adapter, self._n_adapters, device=self.device)

    def _lora_args(self) -> tuple:
        """The sharded builders' trailing adapter operands (stack, selector)."""
        return () if self.lora is None else (self.lora, self._lora_sel())

    _HINT_QUANTUM = 512

    def _round_len_hint(self, active: np.ndarray, n: int) -> int | None:
        """Bound on every active slot's cache length at the END of an n-step
        round, quantized to ``_HINT_QUANTUM``; None when the whole cache is
        needed anyway, or on the sharded path (as in JAX). The port's
        kernels walk each row's own length, so the hint is passed along and
        unused."""
        if self.mesh is not None or not active.any():
            return None
        mx = int(self._slot_len[active].max()) + n + 1
        q = self._HINT_QUANTUM
        bucket = -(-mx // q) * q
        return bucket if bucket < self.cfg.max_seq_len else None

    def _unpack_decode(self, out):
        """Split decode_multi's outputs; the round's ONE readback happens
        here (tokens, and logprobs when asked for)."""
        toks, self.pending_tok, self.cache = out[:3]
        host = [t.cpu().numpy() for t in (toks,) + tuple(out[3:])]
        toks, rest = host[0], host[1:]
        self._last_logprobs = rest.pop(0) if self.return_logprobs else None
        self._last_topk = (rest[0], rest[1]) if self.topk_logprobs else None
        return toks

    # -- sampling -------------------------------------------------------------

    def _sampling_state(self) -> dict | None:
        """Per-slot sampling tensors, or None for the greedy (argmax) path."""
        if not self.enable_sampling:
            return None
        return core_sampling.state_tensors(self._slot_sampling, self.device)

    def _first_logprobs(self, logits, first) -> np.ndarray | None:
        if not self.return_logprobs:
            return None
        return llama.token_logprob(logits, first).cpu().numpy()

    def _first_topk(self, logits):
        if not self.topk_logprobs:
            return None
        v, i = llama.topk_token_logprobs(logits, self.topk_logprobs)
        return v.cpu().numpy(), i.cpu().numpy()

    def _first_tokens(self, logits, positions: np.ndarray) -> torch.Tensor:
        """Token choice on prefill logits; ``positions`` is each slot's
        post-prefill length (= the drawn token's absolute position, the same
        key the decode loop uses, so trajectories replay exactly)."""
        state = self._sampling_state()
        if state is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return core_sampling.sample_tokens(logits, state,
                                           torch.from_numpy(positions).to(self.device))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -- one scheduling round -------------------------------------------------

    def _record(self, slot: int, tokens: list[int], logprobs=None, topk=None) -> None:
        req = self.sched.slots[slot].request
        uid = req.uid if req is not None else None
        before = len(req.output) if req is not None else 0
        if self.sched.record_tokens(slot, tokens):
            self.stats.finished += 1
            self._on_retired(slot)
        if req is not None and logprobs is not None:
            # keep the logprob list aligned with the tokens record_tokens kept
            # (a stop match may make the net change negative: nothing to add)
            kept = len(req.output) - before
            if kept > 0:
                req.logprobs.extend(float(lp) for lp in logprobs[:kept])
        if req is not None and topk is not None:
            kept = len(req.output) - before
            if kept > 0:
                vals, ids = topk
                req.topk.extend(
                    ([int(t) for t in ids[j]], [float(v) for v in vals[j]])
                    for j in range(min(kept, len(ids)))
                )
        if uid is not None and uid not in self._first_token_seen:
            self._first_token_seen.add(uid)
            t0 = self._submit_time.get(uid)
            if t0 is not None:
                self.stats.ttfts_s.append(time.time() - t0)

    def _validate_prefill(self, logits, admit_mask, where: str) -> None:
        if self.debug_validate:
            from starflashattention_tpu_torch.utils import sanitize

            # only admitted rows: an inactive slot's row owes no numeric contract
            rows = self._to_device(np.nonzero(admit_mask)[0])
            sanitize.check_finite({"prefill_logits": logits[rows]}, where)

    def _take_first_tokens(self, logits, texts, slots) -> None:
        """Choose, store as pending and record the first token of every
        slot in ``slots`` from these prefill logits (one readback)."""
        positions = np.zeros((self.num_slots,), np.int32)
        for slot, _req, text in texts:
            positions[slot] = len(text)
        first = self._first_tokens(logits, positions)
        mask = np.zeros((self.num_slots,), bool)
        mask[slots] = True
        self.pending_tok = torch.where(self._to_device(mask), first, self.pending_tok)
        first_host = first.cpu().numpy()
        first_lp = self._first_logprobs(logits, first)
        first_tk = self._first_topk(logits)
        for slot in slots:
            self._record(
                slot, [int(first_host[slot])],
                logprobs=None if first_lp is None else [first_lp[slot]],
                topk=None if first_tk is None else (first_tk[0][slot][None], first_tk[1][slot][None]),
            )

    def _admit_and_prefill(self) -> None:
        admitted = self.sched.admit()
        for _slot, req in admitted:  # before any page is allocated for them
            if req.adapter is not None and not 0 <= req.adapter < self._n_adapters:
                raise ValueError(f"request {req.uid}: adapter {req.adapter} out of range: the engine holds "
                                 f"{self._n_adapters} adapters")
        admitted = self._prepare_admit(admitted)
        if not admitted:
            return
        for slot, req in admitted:
            # every admission sets it: a re-admitted (preempted) request re-prefills on its own adapter
            self._slot_adapter[slot] = -1 if req.adapter is None else req.adapter
            self._slot_sampling[slot] = req.sampling
        # A re-admitted (preempted) request prefills prompt + generated-so-far.
        texts = [(slot, r, r.prompt + r.output) for slot, r in admitted]
        for slot, _r, text in texts:
            self._slot_len[slot] = len(text)  # post-prefill cache length
        self._update_history(texts)
        # offs[slot] tokens are already cached (prefix-cache hits): those
        # slots prefill only their SUFFIX and keep their (pre-set) length;
        # the prefix bound covers the largest offset, quantized to the pad
        # grid as the JAX engine quantizes its static shapes.
        offs = self._admission_offsets(texts)
        if self.prefill_chunk is not None:
            self._prefill_chunked(texts, offs)
            return
        pad = max(len(t) - offs[slot] for slot, _, t in texts)
        pad = -(-pad // self.prefill_pad) * self.prefill_pad
        toks = np.zeros((self.num_slots, pad), np.int32)
        new_lengths = np.zeros((self.num_slots,), np.int32)
        admit_mask = np.zeros((self.num_slots,), bool)
        reset_mask = np.zeros((self.num_slots,), bool)
        for slot, _req, text in texts:
            suffix = text[int(offs[slot]):]
            toks[slot, : len(suffix)] = suffix
            new_lengths[slot] = len(suffix)
            admit_mask[slot] = True
            reset_mask[slot] = offs[slot] == 0
        max_off = int(offs.max()) if len(texts) else 0
        prefix_bound = -(-max_off // self.prefill_pad) * self.prefill_pad
        logits = self._prefill_call(
            self._to_device(toks), self._to_device(new_lengths), self._to_device(admit_mask),
            self._to_device(reset_mask), prefix_len=prefix_bound,
        )
        self._validate_prefill(logits, admit_mask, "prefill")
        self.stats.prefill_rounds += 1
        self._after_prefill(texts)
        self._take_first_tokens(logits, texts, [slot for slot, _, _ in texts])

    def _prefill_chunked(self, texts, offs) -> None:
        """Ingest admitted prompts in fixed-width chunks. A slot goes inactive
        once its prompt is exhausted; its first token comes from the chunk
        that consumed its last prompt token. ``offs[slot]`` tokens are already
        cached; the prefix bound of each call covers the deepest row
        position, quantized to the chunk grid."""
        chunk = self.prefill_chunk
        longest = max(len(t) - offs[slot] for slot, _, t in texts)
        max_off = max(int(offs[slot]) for slot, _, t in texts)
        for lo in range(0, longest, chunk):
            toks = np.zeros((self.num_slots, chunk), np.int32)
            new_lengths = np.zeros((self.num_slots,), np.int32)
            admit_mask = np.zeros((self.num_slots,), bool)
            reset_mask = np.zeros((self.num_slots,), bool)
            finishing = []
            for slot, _req, text in texts:
                suffix = text[int(offs[slot]):]
                if lo >= len(suffix):
                    continue
                n = min(chunk, len(suffix) - lo)
                toks[slot, :n] = suffix[lo : lo + n]
                new_lengths[slot] = n
                admit_mask[slot] = True
                reset_mask[slot] = lo == 0 and offs[slot] == 0
                if lo + n == len(suffix):
                    finishing.append(slot)
            prefix_bound = -(-(max_off + lo) // chunk) * chunk if (max_off or lo) else 0
            logits = self._prefill_call(
                self._to_device(toks), self._to_device(new_lengths),
                self._to_device(admit_mask), self._to_device(reset_mask),
                prefix_len=prefix_bound,
            )
            self._validate_prefill(logits, admit_mask, f"prefill_chunk@{lo}")
            self.stats.prefill_rounds += 1
            if lo + chunk >= longest:
                self._after_prefill(texts)
            if finishing:
                self._take_first_tokens(logits, texts, finishing)

    def _update_history(self, texts) -> None:
        """Write admitted prompts (+ resumed output) into the drafting
        history (prompt-lookup engines only), whole rows, so a reused slot
        carries no stale tokens; one host-to-device copy, no readback."""
        if self.history is None:
            return
        s_hist = self.history.shape[1]
        mask = np.zeros((self.num_slots,), bool)
        rows = np.zeros((self.num_slots, s_hist), np.int32)
        for slot, _req, text in texts:
            mask[slot] = True
            rows[slot, : min(len(text), s_hist)] = text[:s_hist]
        self.history = torch.where(self._to_device(mask)[:, None], self._to_device(rows), self.history)

    def _spec_decode_round(self, active: np.ndarray, n: int) -> None:
        """One round of ``n`` verify steps (JAX engine.py:716-785) with one
        readback; counts only the tokens ``record_tokens`` keeps, and a
        verify step only if it kept one."""
        t0 = time.time()
        hint = self._round_len_hint(active, n * (self.spec_decode + 1))
        act = self._to_device(active)
        if self.mesh is not None and self.draft_cache is not None:
            toks, counts, self.pending_tok, self.cache, self.draft_cache = self._tp_spec_decode_draft(
                self.params, self.cache, self.draft_params, self.draft_cache, self.pending_tok, self.cos,
                self.sin, self.dcos, self.dsin, act)
        elif self.mesh is not None:
            toks, counts, self.pending_tok, self.cache, self.history = self._tp_spec_decode(
                self.params, self.cache, self.history, self.pending_tok, self.cos, self.sin, act)
        elif self.draft_cache is not None:
            toks, counts, self.pending_tok, self.cache, self.draft_cache = llama.spec_decode_multi_draft(
                self.params, self.cache, self.draft_params, self.draft_cache, self.pending_tok,
                self.cos, self.sin, self.dcos, self.dsin, act, self.cfg, self.draft_cfg, n,
                num_draft=self.spec_decode, max_len_hint=hint)
        else:
            toks, counts, self.pending_tok, self.cache, self.history = llama.spec_decode_multi(
                self.params, self.cache, self.history, self.pending_tok, self.cos, self.sin, act,
                self.cfg, n, num_draft=self.spec_decode, ngram=self.spec_ngram, max_len_hint=hint)
        toks_host = toks.cpu().numpy()  # (B, n, k+1): the round's readback
        counts_host = counts.cpu().numpy()  # (B, n)
        self.stats.decode_seconds += time.time() - t0
        self._slot_len[active] += counts_host[active].sum(axis=1)
        self.stats.decode_rounds += 1
        for i in range(self.num_slots):
            if not active[i]:
                continue
            emitted = [int(t) for s in range(n) for t in toks_host[i, s, : counts_host[i, s]]]
            # a slot may hit its budget / EOS mid-round and discard the rest
            req = self.sched.slots[i].request
            before = len(req.output) if req is not None else 0
            self._record(i, emitted)
            kept = len(req.output) - before if req is not None else 0
            self.stats.decode_tokens += kept
            remaining = kept
            for s in range(n):
                if remaining <= 0:
                    break
                self.stats.spec_steps += 1
                remaining -= int(counts_host[i, s])

    def _decode_round(self) -> None:
        active = np.asarray(self.sched.active_mask())
        if not active.any():
            return
        active = self._before_decode(active)
        if not active.any():
            return
        n = self.steps_per_round
        if self.spec_decode is not None:
            self._spec_decode_round(active, n)
            return
        t0 = time.time()
        hint = self._round_len_hint(active, n)
        toks_host = self._decode_call(self._to_device(active), n, max_len_hint=hint)
        self.stats.decode_seconds += time.time() - t0
        self._slot_len[active] += n
        self.stats.decode_rounds += 1
        self.stats.decode_tokens += int(active.sum()) * n
        for i in range(self.num_slots):
            if active[i]:
                # record_tokens caps at the slot's budget; the final round's
                # overshoot is discarded (its appends sit in the reserved slack)
                self._record(
                    i, [int(t) for t in toks_host[i]],
                    logprobs=None if self._last_logprobs is None else self._last_logprobs[i],
                    topk=None if self._last_topk is None
                    else (self._last_topk[0][i], self._last_topk[1][i]),
                )

    # -- failure recovery -------------------------------------------------------

    def recover_device_state(self) -> None:
        raise _unported("failure recovery (recover_device_state)", "17")

    def run_resilient(self, **kwargs) -> int:
        raise _unported("failure recovery (run_resilient)", "17")

    # -- public API -----------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the counters (e.g. after a warm-up pass)."""
        self.stats = EngineStats()
        self._submit_time.clear()
        self._first_token_seen.clear()

    def submit(self, req: Request) -> None:
        if not req.sampling.is_greedy and not self.enable_sampling:
            raise ValueError(
                f"request {req.uid} asks for sampling "
                f"(temperature={req.sampling.temperature}) but the engine was "
                "built with enable_sampling=False (greedy only)")
        self.sched.submit(req)
        self._submit_time[req.uid] = time.time()

    def run(self) -> None:
        """Drive until all submitted requests complete."""
        while self.sched.has_work:
            self._admit_and_prefill()
            self._decode_round()

    def generate(
        self, prompts: list[list[int]], max_new_tokens: int, eos_token=None,
        sampling: core_sampling.SamplingParams | list | None = None,
        stop: list[list[int]] | None = None,
        on_token=None,
        adapters: list | None = None,
    ):
        """Submit + run + collect outputs in order. ``sampling`` is one
        SamplingParams for all prompts or a per-prompt list; ``stop``
        sequences apply to every prompt (matched tokens are truncated);
        ``on_token(request, token)`` streams tokens as they are recorded.
        ``adapters``: one adapter index (or None, the base model) a prompt."""
        if adapters is None:
            adapters = [None] * len(prompts)
        elif len(adapters) != len(prompts):
            raise ValueError(f"adapters has {len(adapters)} entries for {len(prompts)} prompts")
        if sampling is None:
            samp = [core_sampling.GREEDY] * len(prompts)
        elif isinstance(sampling, core_sampling.SamplingParams):
            samp = [sampling] * len(prompts)
        else:
            samp = list(sampling)
        if len(samp) != len(prompts):
            raise ValueError(f"sampling has {len(samp)} entries for {len(prompts)} prompts")
        reqs = [
            Request(uid=i, prompt=list(p), max_new_tokens=max_new_tokens, eos_token=eos_token,
                    sampling=s, stop=stop, on_token=on_token, adapter=a)
            for i, (p, s, a) in enumerate(zip(prompts, samp, adapters))
        ]
        for r in reqs:
            self.submit(r)
        self.run()
        return [r.output for r in reqs]


class PagedEngine(Engine):
    """Paged-KV continuous-batching engine: decode reads pages through the
    page table with kernel K7 and appends through it with kernel K8;
    physical pages come from a per-sequence allocator, the C++ page pool
    when it builds (``native=None``, the default, or ``native=True``, which
    raises if it cannot) else ``cache.paged.SeqPagePool``."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        num_slots: int = 8,
        steps_per_round: int = 8,
        prefill_pad: int = 64,
        prefill_chunk: int | None = None,
        page_size: int = 128,
        num_pages: int | None = None,
        native: bool | None = None,
        mesh=None,
        enable_sampling: bool = False,
        return_logprobs: bool = False,
        prefix_cache: bool = False,
        debug_validate: bool = False,
        lora_adapters: list | None = None,
        topk_logprobs: int = 0,
        device: torch.device | str | None = None,
    ):
        """``prefix_cache=True`` enables automatic prefix caching: admissions
        whose prompt prefix matches full pages already in the pool reuse
        them and prefill only the suffix. Refcount-0 cached pages stay warm
        and are evicted (LRU) only under pool pressure, before any
        preemption. With ``mesh`` the pool's KV heads shard over the model
        axis and its pages over the data axis: ``num_pages`` is then the
        pool of ONE data shard, which owns its own allocator (page ids local
        to the shard); ``prefix_cache`` is refused there, as in JAX."""
        if prefix_cache and mesh is not None:
            raise ValueError("prefix_cache is not supported on sharded engines yet (per-data-shard pools use "
                             "local page ids)")
        self.page_size = page_size
        self.pages_per_seq = -(-cfg.max_seq_len // page_size)
        data = None if mesh is None else mesh.axes.get("data")
        self._data_shards = 1 if data is None else data.size
        self._slots_per_shard = max(num_slots // self._data_shards, 1)
        # Default pool: every slot of a shard can hold a full sequence (+ null page 0).
        self.num_pages = num_pages or self._slots_per_shard * self.pages_per_seq + 1
        self.pools = [self._make_pool(self.num_pages, native) for _ in range(self._data_shards)]
        self._handles: dict[int, int] = {}  # slot -> pool handle
        self._admit_order: list[int] = []  # slots by admission recency
        self._host_table = np.zeros((num_slots, self.pages_per_seq), np.int32)
        self._host_len = np.zeros((num_slots,), np.int64)
        self._table_dirty = False
        if prefix_cache:
            from starflashattention_tpu_torch.serving.prefix_cache import PrefixCache

            self._prefix = PrefixCache(page_size)
        else:
            self._prefix = None
        # pages the slot references but the PREFIX STORE owns (refcounted);
        # they precede the slot's private (handle-owned) pages in its table
        self._cached_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self._cached_len = np.zeros((num_slots,), np.int64)
        # Sliding-window rolling buffer: the count of leading private pages
        # reclaimed per slot (null table entries the windowed walk never
        # reads), and the pinned pages backing each slot's sink blocks.
        self._reclaimed = np.zeros((num_slots,), np.int64)
        self._sink_pages: list[list[int]] = [[] for _ in range(num_slots)]
        # The JAX kernel's walk block (pages_per_compute_block adjusted to
        # divide pages_per_seq): reclamation stays a whole block below its
        # walk, so the page tables equal JAX's.
        ppcb = min(cfg.pages_per_compute_block, self.pages_per_seq)
        while self.pages_per_seq % ppcb:
            ppcb -= 1
        self._walk_block_pages = ppcb
        super().__init__(
            params, cfg, num_slots, steps_per_round, prefill_pad, prefill_chunk=prefill_chunk,
            mesh=mesh, enable_sampling=enable_sampling, return_logprobs=return_logprobs,
            debug_validate=debug_validate, lora_adapters=lora_adapters,
            topk_logprobs=topk_logprobs, device=device,
        )

    @property
    def pool(self):
        """The allocator of an engine with one data shard."""
        assert self._data_shards == 1, "a sharded engine has one pool per data shard"
        return self.pools[0]

    def _pool_for(self, slot: int):
        return self.pools[slot // self._slots_per_shard]

    @staticmethod
    def _make_pool(num_pages: int, native: bool | None):
        if native is not False:
            from starflashattention_tpu_torch.utils.native import NativePagePool

            try:
                return NativePagePool(num_pages)
            except RuntimeError:  # the C++ pool did not build here
                if native:
                    raise
        return paged.SeqPagePool(num_pages)

    # -- backend hooks --------------------------------------------------------

    def _build_sharded_fns(self, tp) -> None:
        self._tp_decode_multi = tp.make_tp_decode_multi_paged(
            self.mesh, self.cfg, self.steps_per_round, sampling=self.enable_sampling,
            with_logprobs=self.return_logprobs, topk_logprobs=self.topk_logprobs, lora_stack=self.lora)
        fns = {}

        def tp_prefill_for(prefix_len: int):  # one function a chunk index, as JAX's programs
            if prefix_len not in fns:
                fns[prefix_len] = tp.make_tp_prefill_serving_paged(self.mesh, self.cfg, prefix_len=prefix_len,
                                                                   lora_stack=self.lora)
            return fns[prefix_len]

        self._tp_prefill = tp_prefill_for

    def _init_cache(self):
        """The pools (under ``mesh`` the data shards' partitions side by
        side, then this rank's shard of them)."""
        hkv, d = self.cfg.kv_cache_dims()
        cache = paged.init_paged_cache(
            self.cfg.num_layers, self.num_slots, hkv, d, num_pages=self.num_pages * self._data_shards,
            page_size=self.page_size, pages_per_seq=self.pages_per_seq,
            dtype=llama.torch_dtype(self.cfg.dtype), quant_mode=self.cfg.quant_mode,
            calibration_scale=self.cfg.kv_calibration_scale, device=self.device,
        )
        if self.mesh is None:
            return cache
        from starflashattention_tpu_torch.parallel import tp

        return tp.shard_paged_cache(cache, self.mesh)

    def _local_table(self) -> np.ndarray:
        """The host table rows of this rank's data shard."""
        if self._data_shards == 1:
            return self._host_table
        i = self.mesh.axes["data"].index
        return self._host_table[i * self._slots_per_shard:(i + 1) * self._slots_per_shard]

    def _sync_table(self) -> None:
        """Copy the host table (this rank's rows under ``mesh``) into the
        cache's persistent device table: one blocking ``copy_`` on the
        current stream, so every kernel queued before it has read the old
        table and every kernel after reads the new one."""
        if self._table_dirty:
            self.cache.page_table.copy_(torch.from_numpy(self._local_table()))
            self._table_dirty = False

    def _write_row(self, slot: int) -> None:
        """The slot's table row: shared prefix pages, pinned sink pages, null
        entries for reclaimed pages, then the handle's surviving pages."""
        row = np.zeros((self.pages_per_seq,), np.int32)
        shared = self._cached_pages[slot]
        row[: len(shared)] = shared
        sink = self._sink_pages[slot]
        row[len(shared) : len(shared) + len(sink)] = sink
        if slot in self._handles:
            pages = self._pool_for(slot).seq_pages(self._handles[slot])
            off = len(shared) + len(sink) + int(self._reclaimed[slot])
            row[off : off + len(pages)] = pages
        self._host_table[slot] = row
        self._table_dirty = True

    def _grow(self, slot: int, new_len: int) -> bool:
        """Extend the slot's private pages to cover ``new_len`` tokens
        (prefix-cache pages already cover its first ``_cached_len``, and
        pinned sink pages and reclaimed pages need no backing); on exhaustion
        evict warm cached pages first, then return False (the caller decides
        whom to preempt)."""
        held = (len(self._sink_pages[slot]) + int(self._reclaimed[slot])) * self.page_size
        private = max(int(new_len) - int(self._cached_len[slot]) - held, 0)
        pool = self._pool_for(slot)
        while True:
            try:
                pool.seq_extend(self._handles[slot], private, self.page_size)
                break
            except MemoryError:
                if self._prefix is None:
                    return False
                evicted = self._prefix.evict_lru(8)
                if not evicted:
                    return False
                pool.free_raw(evicted)
        self._write_row(slot)
        return True

    def _release(self, slot: int) -> None:
        pool = self._pool_for(slot)
        handle = self._handles.pop(slot, None)
        if handle is not None:
            pool.seq_free(handle)
        if self._sink_pages[slot]:
            pool.free_raw(self._sink_pages[slot])
            self._sink_pages[slot] = []
        if self._prefix is not None and self._cached_pages[slot]:
            self._prefix.release(self._cached_pages[slot])
        self._cached_pages[slot] = []
        self._cached_len[slot] = 0
        self._reclaimed[slot] = 0
        if slot in self._admit_order:
            self._admit_order.remove(slot)
        self._host_len[slot] = 0
        # zero row -> null page 0; synced before the next device call, so a
        # reused physical page never receives a stale slot's append
        self._write_row(slot)

    def _on_retired(self, slot: int) -> None:
        self._release(slot)

    def _preempt_youngest(self, but_not: int | None = None, shard: int | None = None) -> int | None:
        """Free the most recently admitted running slot's pages and requeue
        its request; ``shard`` restricts the candidates to one data shard's
        pool (freeing another shard's pages helps nothing). Returns the
        slot, or None if there is no candidate."""
        for slot in reversed(self._admit_order):
            if slot == but_not or (shard is not None and slot // self._slots_per_shard != shard):
                continue
            self.sched.preempt(slot)
            self._release(slot)
            self.stats.preemptions += 1
            return slot
        return None

    def _prepare_admit(self, admitted):
        """Allocate pages for each admitted prompt; on the first miss, this
        and every later admission goes back to the queue front in FCFS order.
        With the prefix cache on, each prompt first reuses its longest run of
        resident full pages and allocates only the remainder."""
        accepted, rejected = [], []
        exhausted = False
        for slot, req in admitted:
            if not exhausted:
                text = req.prompt + req.output
                if self._prefix is not None:
                    pages, matched = self._prefix.match(text, self._adapter_key(req))
                    self._cached_pages[slot] = pages
                    self._cached_len[slot] = matched
                self._handles[slot] = self._pool_for(slot).seq_new()
                need = len(text)
                if self._grow(slot, need):
                    self._admit_order.append(slot)
                    self._host_len[slot] = need
                    accepted.append((slot, req))
                    continue
                self._pool_for(slot).seq_free(self._handles.pop(slot))
                if self._prefix is not None and self._cached_pages[slot]:
                    self._prefix.release(self._cached_pages[slot])
                self._cached_pages[slot] = []
                self._cached_len[slot] = 0
                exhausted = True
            rejected.append(slot)
        for slot in reversed(rejected):
            self.sched.preempt(slot)  # back to the queue front, slot freed
        self.stats.prefix_hits = self._prefix.hits if self._prefix else 0
        self.stats.prefix_tokens_reused = self._prefix.tokens_reused if self._prefix else 0
        return accepted

    @staticmethod
    def _adapter_key(req: Request) -> int:
        """The prefix cache's salt: a page's KV holds its writer's adapter's
        ``wqkv`` delta, so pages match within one adapter (-1: the base)."""
        return -1 if req.adapter is None else int(req.adapter)

    def _admission_offsets(self, texts) -> np.ndarray:
        """Prefix-cache hits skip their cached tokens at prefill; their device
        length must equal the cached token count BEFORE the (reset=False)
        suffix prefill reads it as the write offset."""
        offs = np.zeros((self.num_slots,), np.int32)
        if self._prefix is None:
            return offs
        for slot, _req, _text in texts:
            offs[slot] = int(self._cached_len[slot])
        mask = offs > 0
        if mask.any():
            self.cache.lengths.copy_(torch.where(self._to_device(mask), self._to_device(offs),
                                                 self.cache.lengths))
        return offs

    def _after_prefill(self, texts) -> None:
        """Publish each admitted prompt's freshly written full pages to the
        prefix store (ownership moves out of the slot's handle; the slot keeps
        a reference). Keys cover PROMPT tokens only, salted with the
        request's adapter."""
        if self._prefix is None:
            return
        for slot, req, _text in texts:
            if slot not in self._handles:
                continue
            have = len(self._cached_pages[slot])
            n_full = len(req.prompt) // self.page_size
            run = self._prefix.insert_run(req.prompt, have, n_full - have, self._adapter_key(req))
            if run <= 0:
                continue
            transfer = self._pool_for(slot).seq_release_prefix(self._handles[slot], run)
            adopted = self._prefix.insert(req.prompt, have, transfer, self._adapter_key(req))
            assert len(adopted) == run, "insert_run promised these keys were new"
            self._cached_pages[slot].extend(adopted)
            self._cached_len[slot] += run * self.page_size
            # the table row is unchanged (same physical ids, same order)

    def _reclaim_window(self, active: np.ndarray) -> None:
        """Sliding-window rolling buffer (JAX engine.py:1255-1305): free the
        private pages below each active slot's current walk start, ``max(len
        - window, 0) // bk`` walk blocks (bk = walk_block_pages * page_size;
        the start only grows with the length, so those pages are dead for
        good), and pin the ones that back the sink walk blocks. Runs before
        the round's growth, so freed pages back this round's allocations."""
        w = self.cfg.sliding_window
        if w is None or self.cfg.sliding_window_pattern != 1:
            return  # alternating full layers still read every page
        wp = self._walk_block_pages
        bk = wp * self.page_size
        sinks = self.cfg.attention_sinks
        sink_lp = -(-sinks // bk) * wp if sinks else 0  # logical pages the sink walk visits
        for slot in list(self._admit_order):
            if not active[slot] or slot not in self._handles:
                continue
            freeable = max(int(self._host_len[slot]) - w, 0) // bk * wp  # pre-round length
            handle = self._handles[slot]
            pool = self._pool_for(slot)
            owned = len(pool.seq_pages(handle))
            # first logical page the handle still owns
            cur = (int(self._cached_len[slot]) // self.page_size + len(self._sink_pages[slot])
                   + int(self._reclaimed[slot]))
            pin = min(max(min(freeable, sink_lp) - cur, 0), owned)
            if pin > 0:
                self._sink_pages[slot].extend(pool.seq_release_prefix(handle, pin))
                cur += pin
            n = min(max(freeable - max(cur, sink_lp), 0), owned - pin)
            if n > 0:
                pool.free_raw(pool.seq_release_prefix(handle, n))
                self._reclaimed[slot] += n
            if pin > 0 or n > 0:
                self._write_row(slot)

    def _before_decode(self, active: np.ndarray) -> np.ndarray:
        """Reclaim out-of-window pages, then grow every active slot to cover
        this round's appends; preempt the youngest slots on exhaustion (their
        requests resume later)."""
        active = active.copy()
        self._reclaim_window(active)
        for slot in list(self._admit_order):  # oldest first
            if not active[slot]:
                continue
            need = int(self._host_len[slot]) + self.steps_per_round
            while not self._grow(slot, need):
                victim = self._preempt_youngest(but_not=slot, shard=slot // self._slots_per_shard)
                if victim is None:
                    raise MemoryError(
                        f"paged pool too small for one sequence: slot {slot} needs {need} "
                        f"tokens, pool {self.num_pages - 1} pages x {self.page_size}")
                active[victim] = False
        for slot in range(self.num_slots):
            if active[slot]:
                self._host_len[slot] += self.steps_per_round
        if self.debug_validate:
            self._validate_tables(active)
        self._sync_table()
        return active

    def _validate_tables(self, active: np.ndarray) -> None:
        """Sanitizer pass on the exact host table the next round consumes;
        reclaimed (null) entries sit between the shared prefix and pinned
        sink pages and the first surviving private page."""
        from starflashattention_tpu_torch.utils import sanitize

        reclaimed_below = None
        if self.cfg.sliding_window is not None:
            sink_kept = np.asarray([len(p) for p in self._sink_pages], np.int64)
            reclaimed_below = self._cached_len // self.page_size + sink_kept + self._reclaimed
        sanitize.check_page_table(
            self._host_table, self._host_len, self.page_size, self.num_pages, active=active,
            shard_of=np.arange(self.num_slots) // self._slots_per_shard, shared_ok=self._prefix.resident_set() if self._prefix else None,
            reclaimed_below=reclaimed_below,
        )
        pre = np.where(active, self._host_len - self.steps_per_round, 0)
        sanitize.check_append_window(pre, self.steps_per_round,
                                     self.pages_per_seq * self.page_size)

    def _prefill_call(self, toks, new_lengths, admit_mask, reset_mask, prefix_len=0):
        self._sync_table()
        if self.mesh is not None:
            logits, self.cache = self._tp_prefill(prefix_len)(self.params, self.cache, toks, new_lengths,
                                                              admit_mask, reset_mask, self.cos, self.sin,
                                                              *self._lora_args())
            return logits
        logits, self.cache = llama.prefill_serving_paged(
            self.params, self.cache, toks, new_lengths, admit_mask, reset_mask,
            self.cos, self.sin, self.cfg, prefix_len=prefix_len, lora=self.lora, lora_sel=self._lora_sel(),
        )
        return logits

    def _decode_call(self, active, n, max_len_hint=None):
        if self.mesh is not None:
            return self._unpack_decode(self._tp_decode_call(active))
        out = llama.decode_multi_paged(
            self.params, self.cache, self.pending_tok, self.cos, self.sin, active, self.cfg, n,
            sampling=self._sampling_state(), with_logprobs=self.return_logprobs,
            topk_logprobs=self.topk_logprobs, max_len_hint=max_len_hint,
            lora=self.lora, lora_sel=self._lora_sel(),
        )
        return self._unpack_decode(out)
