"""Continuous-batching LM serving: a fixed pool of slots decoding in
lockstep.

Counterpart of ``resnet_accel_tpu/runtime/serving.py``.  Every engine step
advances all active slots by ``chunk`` tokens; a request joins a free slot
the moment one drains, and its prompt rides the same decode steps, each
prompt token forced in place of the slot's feedback (its logits ignored
until the prompt is consumed).

- The host scheduler (``_Request`` and ``_IterationScheduler``: chunk
  inputs, output accounting, the queue) is the port's own copy of the JAX
  package's; the paged engine (``runtime/paged.py``) shares it.
- The device step is ``TransformerLMInt8Module.decode_step`` over the slots'
  stacked caches, with a position per slot.  One step's ``chunk``
  micro-steps run without a host sync, and their outputs come back in one
  copy, as the JAX engine's one dispatch a chunk.
- A recycled slot only resets its position: attention masks by position,
  so stale K/V is never read.  Idle slots' positions are re-zeroed after
  every chunk, so they stay bounded.
- Greedy streams equal ``generate``'s token-by-token prefill run
  (``parallel_prefill=False``) for each request, however requests
  interleave.  Sampling (``temperature``, ``top_k``, a ``seed`` per
  request) keeps one key per slot, split once per consumed token through
  ``models.sampling.sampled_token``, so a slot's stream equals ``sample``'s
  for the same seed.  ``eos`` stops a request early, the token included.
- No kernel runs here: ingesting prompts by decode micro-steps reaches no
  kernel of the port (the JAX engine's reaches no Pallas kernel either).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from resnet_accel_tpu_torch.models.sampling import pick_tokens, prng_key


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    n_new: int
    seed: int = 0                # per-request sampling stream
    eos: Optional[int] = None    # stop early on this token
    fed: int = 0                 # prompt tokens consumed so far
    out: List[int] = dataclasses.field(default_factory=list)
    # Preemption by recompute (paged engine, reserve="ondemand"): a
    # preempted request folds its generated tokens into the prompt,
    # accumulates them in ``emitted`` and keeps its key in ``saved_key``,
    # so that the resumed stream continues where it stopped.
    total_new: Optional[int] = None   # original n_new (n_new = remaining)
    emitted: List[int] = dataclasses.field(default_factory=list)
    saved_key: Optional[torch.Tensor] = None

    @property
    def prefilling(self) -> bool:
        return self.fed < len(self.prompt)

    @property
    def done(self) -> bool:
        if self.prefilling:
            return False
        if len(self.out) >= self.n_new:
            return True
        return self.eos is not None and bool(self.out) \
            and self.out[-1] == self.eos


class _IterationScheduler:
    """Host-side iteration-level scheduler shared by the fixed-slot and the
    paged engine: chunk inputs, output accounting, queue drain.  Subclasses
    own slot admission (and, paged, page allocation) and the device step.

    Subclass contract: attributes ``slots``, ``chunk``, ``max_len``,
    ``device``, ``temperature``, ``top_k``, ``_queue``, ``_active``,
    ``_results``, ``_prev``, ``_next_rid`` and ``_lens`` (the slots'
    positions on the device); the hook ``_on_slot_free(slot)`` runs when a
    finished request leaves its slot."""

    def _validated_prompt(self, prompt: Sequence[int], n_new: int,
                          what: str) -> List[int]:
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + n_new > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + n_new ({n_new}) exceeds "
                f"{what} ({self.max_len})")
        return prompt

    def _enqueue(self, prompt: List[int], n_new: int, seed: int,
                 eos: Optional[int]) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, prompt, n_new, seed=seed,
                                    eos=eos, total_new=n_new))
        return rid

    def _chunk_inputs(self):
        """(forced, mask, advance, idle) numpy arrays for one chunk."""
        k = self.chunk
        forced = np.zeros((k, self.slots), np.int64)
        mask = np.zeros((k, self.slots), bool)
        advance = np.zeros((k, self.slots), bool)
        for slot, req in self._active.items():
            rem = req.prompt[req.fed:req.fed + k]
            forced[:len(rem), slot] = rem
            mask[:len(rem), slot] = True
            # outputs are consumed from the last prompt step onward
            first = max(len(req.prompt) - 1 - req.fed, 0)
            advance[first:, slot] = True
        idle = np.array([s not in self._active
                         for s in range(self.slots)])
        return forced, mask, advance, idle

    def _account_outputs(self, outs: np.ndarray) -> None:
        """Distribute a chunk's outputs [k, B] to the requests; retire the
        finished ones."""
        self._prev = outs[-1].copy()
        for slot in list(self._active):
            req = self._active[slot]
            for i in range(self.chunk):
                if req.prefilling:
                    req.fed += 1
                    if not req.prefilling:
                        # the last prompt token's logits start generation
                        req.out.append(int(outs[i, slot]))
                elif not req.done:
                    req.out.append(int(outs[i, slot]))
            if req.done:
                self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self._active.pop(slot)
        total = req.total_new if req.total_new is not None else req.n_new
        self._results[req.rid] = (req.emitted + req.out)[:total]
        self._on_slot_free(slot)

    def _on_slot_free(self, slot: int) -> None:
        pass

    def _upload(self, *arrays: np.ndarray):
        """Host arrays to the engine's device."""
        return [torch.as_tensor(a, device=self.device) for a in arrays]

    def _chunk_step(self, step_fn, prev: np.ndarray, keys: torch.Tensor):
        """``chunk`` lockstep micro-steps with no host sync inside:
        ``step_fn(toks [B], lens)`` runs one and returns (logits [B, V],
        lens advanced).  Returns (keys, outs [k, B] on the host, in one
        copy); the caller's ``self._lens`` is updated, idle slots
        re-zeroed."""
        forced, mask, advance, idle = self._upload(*self._chunk_inputs())
        toks = torch.as_tensor(prev, device=self.device)
        lens, outs = self._lens, []
        for i in range(self.chunk):
            toks = torch.where(mask[i], forced[i], toks)
            logits, lens = step_fn(toks, lens)
            toks, keys = pick_tokens(logits, keys, advance[i],
                                     self.temperature, self.top_k)
            outs.append(toks)
        self._lens = torch.where(idle, 0, lens)
        return keys, torch.stack(outs).cpu().numpy()

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drain the queue; returns {request id: generated tokens} for every
        request completed since the last run(), then clears them."""
        for _ in range(max_steps):
            if not self.step_engine():
                break
        else:
            raise RuntimeError(f"engine did not drain in {max_steps} "
                               "steps")
        out, self._results = self._results, {}
        return out

    def results(self) -> Dict[int, List[int]]:
        """Snapshot of completed but uncollected requests (cleared by
        run())."""
        return dict(self._results)


class ContinuousBatcher(_IterationScheduler):
    """Fixed-pool continuous batching over an INT8 LM.

    Args:
        model: ``models.lm.TransformerLMInt8``.
        scales: static activation scales (``model.calibrate(...)``).
        slots: sequence slots stepping together (the static batch).
        max_len: per-slot KV length (default ``model.max_len``).
        chunk: micro-steps per engine step.
        temperature, top_k: engine-level sampling (0: greedy).
        device: ``"cuda"`` (default) or ``"cpu"``.
    """

    def __init__(self, model, scales, slots: int = 4,
                 max_len: Optional[int] = None, chunk: int = 1,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 device="cuda"):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.slots = slots
        self.chunk = chunk
        self.temperature = float(temperature)
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.top_k = top_k
        self.max_len = model.max_len if max_len is None else max_len
        if self.max_len > model.max_len:
            # positions past the model's table would clamp into its last
            # row and corrupt the outputs rather than fail
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's position "
                f"table ({model.max_len})")
        self.model = model
        self.module = model.module(device)
        self.device = self.module.device
        self.scales = self.module.prepare_scales(scales)
        self._caches = self.module.init_caches(self.max_len, lead=(slots,))
        self._lens = torch.zeros(slots, dtype=torch.int64,
                                 device=self.device)
        self._queue: List[_Request] = []
        self._active: Dict[int, _Request] = {}      # slot -> request
        self._results: Dict[int, List[int]] = {}
        self._prev = np.zeros(slots, np.int64)      # last output a slot
        self._keys = torch.zeros((slots, 2), dtype=torch.int64,
                                 device=self.device)
        self._next_rid = 0
        self.steps = 0                               # engine steps
        self.micro_steps = 0                         # lockstep tokens

    # ------------------------------------------------------------- api
    def submit(self, prompt: Sequence[int], n_new: int, seed: int = 0,
               eos: Optional[int] = None) -> int:
        """Enqueue a request; returns its id (see results()).  ``seed``
        selects the request's sampling stream (``sample``'s with
        ``prng_key(seed)``); unused when greedy.  ``eos``: generation stops
        once this token is emitted (it is included)."""
        prompt = self._validated_prompt(prompt, n_new, "slot cache length")
        return self._enqueue(prompt, n_new, seed, eos)

    def _decode(self, toks, lens):
        for c in self._caches:
            c["len"] = lens
        logits, caches = self.module.decode_step(self._caches, toks,
                                                 self.scales)
        return logits, caches[0]["len"]

    @torch.inference_mode()
    def step_engine(self) -> bool:
        """One engine step: admit waiting requests into free slots, then
        advance every slot ``chunk`` tokens.  Returns False when there is
        nothing to do.  A request that finishes mid-chunk feeds its own
        feedback for the rest of it (discarded)."""
        for slot in range(self.slots):
            if slot not in self._active and self._queue:
                req = self._queue.pop(0)
                self._active[slot] = req
                self._lens[slot] = 0
                self._prev[slot] = 0
                self._keys[slot] = prng_key(req.seed, self.device)
        if not self._active:
            return False
        self._keys, outs = self._chunk_step(self._decode, self._prev,
                                            self._keys)
        self.steps += 1
        self.micro_steps += self.chunk
        self._account_outputs(outs)
        return bool(self._active or self._queue)
