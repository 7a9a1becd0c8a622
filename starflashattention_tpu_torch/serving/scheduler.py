"""Continuous-batching scheduler: slots, admission, retirement (host side) —
the port's own copy of the JAX ``serving/scheduler.py``.

Pure-Python bookkeeping — the device never sees this. Policy: FCFS admission
into free slots whenever the prompt fits the slot's cache capacity.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from starflashattention_tpu_torch.core.sampling import GREEDY, SamplingParams


@dataclasses.dataclass
class Request:
    """One generation request."""

    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_token: Optional[int] = None
    # Per-request sampling controls (core/sampling.py). GREEDY by default;
    # sampled requests need an engine built with enable_sampling=True.
    sampling: SamplingParams = GREEDY
    # Multi-token stop sequences: generation retires when the output ends
    # with any of these; the matched sequence is TRUNCATED from ``output``
    # (eos_token, by contrast, is kept — matching common serving APIs).
    stop: Optional[list[list[int]]] = None
    # Streaming: called as on_token(request, token) from the host loop as
    # each token is recorded (once per token, in order, before any stop
    # truncation). Exceptions propagate to the engine's run().
    on_token: Optional[object] = None
    # Multi-LoRA serving: index into the engine's stacked adapters
    # (``lora_adapters``), or None for the base model.
    adapter: Optional[int] = None

    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    # chosen-token log-probabilities, aligned with ``output`` — populated
    # only by engines built with return_logprobs=True
    logprobs: list[float] = dataclasses.field(default_factory=list)
    # per-token top-K alternatives [(ids, logprobs) per output token] under
    # the unmodified distribution — engines built with topk_logprobs=K
    topk: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    budget: int = 0  # new tokens still allowed

    @property
    def free(self) -> bool:
        return self.request is None


class Scheduler:
    def __init__(self, num_slots: int, max_seq_len: int, capacity_slack: int = 0):
        """``capacity_slack`` reserves cache positions for the engine's
        fixed-size decode rounds (up to round_size - 1 overshoot appends)."""
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.capacity_slack = capacity_slack
        self.queue: deque[Request] = deque()
        self.slots = [_Slot() for _ in range(num_slots)]

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens + self.capacity_slack > self.max_seq_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} (+ slack {self.capacity_slack}) "
                f"exceeds capacity {self.max_seq_len}"
            )
        self.queue.append(req)

    def admit(self) -> list[tuple[int, Request]]:
        """Fill free slots from the queue → [(slot_idx, request)].

        A re-admitted (previously preempted) request resumes with its
        remaining budget: its generated tokens stay in ``output`` and its
        effective prompt is ``prompt + output``."""
        admitted = []
        for i, slot in enumerate(self.slots):
            if not self.queue:
                break
            if slot.free:
                req = self.queue.popleft()
                slot.request = req
                slot.budget = req.max_new_tokens - len(req.output)
                admitted.append((i, req))
        return admitted

    def preempt(self, slot_idx: int) -> Request:
        """Evict a running request back to the FRONT of the queue (paged
        engine under pool pressure). Decoding is deterministic — greedy
        trivially, sampled because keys derive from (seed, position)
        (core/sampling.py) — so re-prefilling ``prompt + output`` on
        re-admission reproduces the evicted state exactly; nothing is saved."""
        slot = self.slots[slot_idx]
        req = slot.request
        assert req is not None, f"slot {slot_idx} is free"
        slot.request = None
        slot.budget = 0
        self.queue.appendleft(req)
        return req

    def active_mask(self) -> list[bool]:
        return [not s.free for s in self.slots]

    def record_tokens(self, slot_idx: int, tokens: list[int]) -> bool:
        """Append generated tokens to the slot's request; retire when the
        budget is spent, EOS appears, or a stop sequence completes. Returns
        True if the slot finished."""
        slot = self.slots[slot_idx]
        req = slot.request
        assert req is not None
        for t in tokens:
            if slot.budget <= 0:
                break
            req.output.append(t)
            slot.budget -= 1
            if req.on_token is not None:
                req.on_token(req, t)
            if req.eos_token is not None and t == req.eos_token:
                slot.budget = 0
            elif req.stop:
                for seq in req.stop:
                    n = len(seq)
                    if n and req.output[-n:] == list(seq):
                        # truncate the matched stop sequence (and its
                        # logprobs) — the caller never sees stop tokens
                        del req.output[-n:]
                        del req.logprobs[len(req.output):]
                        slot.budget = 0
                        break
        if slot.budget <= 0:
            req.done = True
            slot.request = None
            return True
        return False

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(not s.free for s in self.slots)
