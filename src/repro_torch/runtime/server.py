"""Continuous-batching decode server (counterpart of
``repro/runtime/server.py``).

The serving loop, as in the reference:

* **Per-slot position counters** -- the KV caches carry a vector ``len``
  (B,), so every batch slot advances independently: admission, prefill and
  retirement are per-slot operations, never whole-batch drains.
* **Prompt-chunked prefill** -- an admitted prompt is consumed in
  ``prefill_chunk``-token waves (:meth:`~repro_torch.models.lm.LM.wave_step`,
  a loop of masked decode micro-steps) interleaved with the decode waves of
  the running slots.  Because a wave is exactly the masked micro-step
  sequence, chunked prefill is bit-identical to whole-prompt prefill at any
  chunk size.
* **Prioritized admission + slot recycling** -- requests queue on a
  priority heap (lower ``Request.priority`` first, FIFO within a class); a
  slot that hits EOS / max-new / max-len retires mid-wave: its cache region
  is zeroed (:meth:`~repro_torch.models.lm.LM.reset_slots`) and the next
  queued request is admitted in the same serving iteration.
* **Cross-program pipelining** (``pipeline=True``) -- each wave's token
  stream is mirrored into the model's
  :meth:`~repro_torch.models.lm.LM.embedding_pipeline` through
  :meth:`~repro_torch.core.executor.PipelineGroup.submit_wave`: the
  decode-embed program (token embed + label gather over the shared embed
  table) and, for an MoE model, the un-dispatch program (a gather over an
  (E·C, D) capacity buffer, fed as the reference feeds it) run through the
  hand-written block gather by default, both in one ``submit_wave``;
  ``compile_stats["pipeline_group"]`` holds the group's accounting.

Per-request service metrics (submit/admit/first-token/done stamps and
per-token times) are recorded on the :class:`Request` itself.

**Fault tolerance**: the loop degrades per request, never per process --
prompt hardening under ``index_policy``, SLO-aware shedding and expiry
(``deadline_s`` / ``ttft_slo_s``, ``capacity_rps`` or ``"auto"``), and a
wave watchdog with bounded retry (``wave_deadline_s``, ``wave_retries``)
that resets the pipeline group and fails only the implicated requests.
Each request ends in exactly one terminal ``status``: ``ok`` | ``shed`` |
``expired`` | ``failed``.

**A sharded model.**  As in the reference, the mesh comes from the model
(``lm.shard``, a :class:`~repro_torch.models.lm.ShardCtx`): the server of
a tensor-parallel :class:`~repro_torch.models.lm.LM` runs on one rank, and
every rank of the model axis runs its own server on the same requests in
the same order -- each wave's collectives pair up, and the all-gathered
logits give every rank the same tokens.  ``compile_stats["executor"]``
then shows the vocab-sharded executor's ``shards``, ``exchange`` and
``replicate_outputs``, and ``compile_stats["access_plans"]`` its plans.
``pipeline=True`` over a mesh raises (ROADMAP.md, Queue 1 item 6d-3).

**The compiled wave.**  The reference compiles the wave and the slot
reset once, in ``__init__`` (``jax.jit(lm.wave_step)``,
``jax.jit(lm.reset_slots)``).  Here, for a model on a CUDA device, the
server captures CUDA graphs of the decode micro-step (one per mask form)
and of the slot reset once, on its own caches (:class:`WaveGraph`), and a
wave replays them: the host issues a copy, a mask and one graph launch a
micro-step instead of every operation of the model.  A ``dense_local``
layer's decode builds its window mask on the device from the caches'
``len``, so its micro-step is captured like any other.  A capture that
fails raises; nothing falls back to the eager wave.  A model whose ``device``
is not a CUDA device (the CPU, or a stub with no ``device``) runs
``lm.wave_step`` / ``lm.reset_slots`` eagerly, and so does a sharded model
whose collectives are staged through host memory (gloo on the card, where
several ranks share one card), which a CUDA graph cannot capture: the
choice follows the group's backend, never an error, and
``serve_stats["wave_graph"]`` / ``["wave_graph_why"]`` record it.  Under
NCCL (one rank a card) the collectives are captured inside the graphs.

**Data flow.**  Host bookkeeping is numpy, as in the reference.  A wave
hands its ``tokens`` and ``lens`` to the wave (``self._wave``) as host
arrays, which reach the card in one copy; the argmax of the wave's logits
comes back once per wave, the loop's one synchronisation.

**The disaggregated tier** (``service="disagg"`` with a
:class:`~repro_torch.runtime.embedding_service.ServicePool`): every
embedding executor the server builds -- the pipeline group's members and
``emb_executor`` -- routes its steps to the pool's replica processes
(cache-keyed on the pool), and ``degrade_policy`` decides what a step does
while every replica is dark.  A ``ServiceUnavailable`` reaching a wave is
an :class:`~repro_torch.runtime.faults.EmberFault`, so the wave
watchdog's reset and retry cover a replica's failover.

**Serving artifacts** (``artifact_dir``, :mod:`repro_torch.core
.artifact`): the boot loads ``emb_executor``'s compile result from there
instead of compiling when its fingerprint and identity match, else
compiles and saves it; the first wave re-saves it (an idempotent
publish), and ``compile_stats["artifact"]`` says where this boot's
compile came from beside the process's load / save / reject counters.
The CUDA graphs of the wave are captured at every boot: the artifact
holds no executables (:mod:`repro_torch.core.artifact`).

An encoder-decoder model is refused (:func:`refuse_encoder_decoder`): the
reference's server does not serve one either.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.access_plan import INDEX_POLICIES
from ..core.executor import SERVICES
from ..models.lm import StaticWave
from .faults import EmberFault, WaveTimeout

#: terminal request statuses (Request.status ends as exactly one of these)
STATUSES = ("ok", "shed", "expired", "failed")


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (L,) int32
    max_new_tokens: int = 16
    priority: int = 0               # lower serves first; FIFO within a class
    deadline_s: Optional[float] = None   # TTFT budget from submit (None: server SLO)
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "queued"          # queued|active -> ok|shed|expired|failed
    error: Optional[str] = None     # typed failure detail (status != ok)
    # service metrics, stamped by the server (perf_counter seconds)
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    token_times: list = dataclasses.field(default_factory=list)
    admitted_wave: Optional[int] = None
    finished_wave: Optional[int] = None


_EMPTY = np.zeros(0, np.int32)


def refuse_encoder_decoder(cfg) -> None:
    """Raise for an encoder-decoder config (``cfg.enc_layers``, whisper):
    each of its requests needs an encoder context -- ``batch_ctx={"enc_out":
    ...}``, its audio's encoder output -- that the server's waves do not
    carry.  The reference's DecodeServer passes none either (its
    ``wave_step`` call has no ``batch_ctx``, so its ``decode_step`` fails
    on ``batch_ctx["enc_out"]``).  Such a model is served through
    ``LM.wave_step(batch_ctx=)``."""
    if getattr(cfg, "enc_layers", 0):
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder model: each request needs an "
            f"encoder context (batch_ctx={{'enc_out': ...}}) that the "
            f"server's waves do not carry, as the reference's DecodeServer "
            f"does not; serve it through LM.wave_step(batch_ctx=)")


class WaveGraph(StaticWave):
    """CUDA graphs of the serving wave: the counterpart of the reference's
    ``jax.jit(lm.wave_step, donate_argnums=(3,))`` and
    ``jax.jit(lm.reset_slots, donate_argnums=(0,))``
    (``repro/runtime/server.py``).

    Three graphs share one memory pool: the micro-step with every slot
    active, the micro-step under the ``active`` mask, and the slot reset,
    all captured once, under ``torch.inference_mode()``, on the caches
    given here.  A graph binds the addresses of those caches and of the
    static buffers, so **the caches must live as long as the graph, and
    ``lm.init_caches`` must not replace them**: a wave refuses other
    caches.  Per micro-step the host issues one device copy of the token
    column, in the masked form one ``torch.gt`` into the mask, and one
    replay.

    Capture needs a warm-up on a side stream, which runs each body once on
    the caches: the unmasked micro-step writes row 0 of every slot; the
    masked one under an all-False mask and the reset with every slot kept
    change nothing.  So after capture one reset with no slot kept zeroes
    every leaf.  A capture that fails raises with its cause; there is no
    eager fallback.

    Kernel launch counts (``kernels.ops.launch_counts``) are kept by the
    wrappers' Python: a capture counts the launches it records into a
    graph and a replay counts nothing, so the launches that replays make
    (an MoE model's un-dispatch gathers) show only in a device trace."""

    def __init__(self, lm, caches: list):
        super().__init__(lm, caches)
        dev = lm.device
        bodies = {"micro-step": self.micro_step,
                  "masked micro-step": self.masked_micro_step,
                  "slot reset": self.zero_slots}
        with torch.inference_mode(), torch.cuda.device(dev):
            self.active.fill_(False)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for body in bodies.values():
                    body()
            torch.cuda.current_stream().wait_stream(side)
            pool = torch.cuda.graph_pool_handle()
            graphs = {}
            for name, body in bodies.items():
                g = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(g, pool=pool):
                        body()
                except RuntimeError as e:
                    raise RuntimeError(f"capturing the {name} of "
                                       f"{lm.cfg.name} in a CUDA graph "
                                       f"failed: {e}") from e
                graphs[name] = g
            self.graphs = graphs
            self._full = graphs["micro-step"].replay
            self._masked = graphs["masked micro-step"].replay
            self._zero = graphs["slot reset"].replay
            self.keep.fill_(False)
            self._zero()               # undo the warm-up's writes


class DecodeServer:
    """The serving loop over ``lm`` (a :class:`~repro_torch.models.lm.LM`,
    or any object with ``init_caches`` / ``wave_step`` / ``reset_slots``;
    the weights live in the model, so there is no ``params`` argument).
    The loop runs on the model's device: the CUDA card unless the model was
    built with ``device="cpu"``."""

    def __init__(self, lm, *, batch_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 prefill_chunk: int = 8, pipeline: bool = False,
                 index_policy: str = "strict",
                 capacity_rps=None,
                 capacity_warmup_waves: int = 5,
                 ttft_slo_s: Optional[float] = None,
                 wave_deadline_s: Optional[float] = None,
                 wave_retries: int = 1,
                 faults=None, service: str = "inproc",
                 service_pool=None, degrade_policy: str = "fail",
                 artifact_dir=None):
        if index_policy not in INDEX_POLICIES:
            raise ValueError(f"index_policy {index_policy!r} not in "
                             f"{INDEX_POLICIES}")
        if service not in SERVICES:
            raise ValueError(f"service {service!r} not in {SERVICES}")
        refuse_encoder_decoder(getattr(lm, "cfg", None))
        tp = getattr(lm, "tp", None)
        if pipeline and tp is not None:
            raise NotImplementedError(
                "the serving pipeline (pipeline=True) of a sharded model is "
                "not ported yet (ROADMAP.md, Queue 1 item 6d-3)")
        self.lm = lm
        # serving artifact: the boot loads the compile result from here
        # instead of compiling; a fresh compile saves at build and again
        # after the first wave
        self.artifact_dir = artifact_dir
        self._artifact_saved = False
        # the disaggregated tier: every member executor routes its steps
        # to the pool (cache-keyed on the pool's identity)
        self.service = service
        self.service_pool = service_pool
        self.degrade_policy = degrade_policy
        self._svc_kw = ({"service": service, "service_pool": service_pool,
                         "degrade_policy": degrade_policy}
                        if service == "disagg" else {})
        self.slots = batch_slots
        self.max_len = max_len
        self.eos = eos_id
        self.prefill_chunk = max(1, int(prefill_chunk))
        # --- fault-tolerance knobs -------------------------------------
        self.index_policy = index_policy
        # calibrated service capacity (requests/s at saturation); drives the
        # submit-time predicted-wait shed.  None disables that check.
        # "auto" self-calibrates from the measured wave-time EWMA after
        # ``capacity_warmup_waves`` waves: capacity ~ slots / (wave_s x
        # avg waves-per-request).
        self._capacity_auto = capacity_rps == "auto"
        self.capacity_rps = None if self._capacity_auto else capacity_rps
        self.capacity_warmup_waves = max(1, int(capacity_warmup_waves))
        self._req_wave_spans = 0    # sum of (finished - admitted wave + 1)
        self._req_span_count = 0
        # server-wide TTFT budget applied to requests without their own
        self.ttft_slo_s = ttft_slo_s
        self.wave_deadline_s = wave_deadline_s
        self.wave_retries = max(0, int(wave_retries))
        self.faults = faults            # chaos injector (site "wave" here)
        self._ewma_wave_s: Optional[float] = None   # measured wave time
        # prompt-validation bound: stub LMs expose `vocab`, real ones cfg
        self._vocab = getattr(lm, "vocab", None) or getattr(
            getattr(lm, "cfg", None), "vocab_size", None)
        self.queue: list = []           # (priority, submit seq, Request)
        self._seq = itertools.count()
        self.active: List[Optional[Request]] = [None] * batch_slots
        self._prompt_left: List[np.ndarray] = [_EMPTY] * batch_slots
        self._next_token = np.zeros(batch_slots, np.int32)
        self._pos = np.zeros(batch_slots, np.int64)   # host position mirror
        self.caches = lm.init_caches(batch_slots, max_len)
        # the compiled wave and slot reset (the reference's two jax.jit):
        # CUDA graphs bound to these caches on the card, else the LM's own
        on_card = torch.device(getattr(lm, "device", "cpu")).type == "cuda"
        staged = tp is not None and tp.staged
        if on_card and not staged:
            graph = WaveGraph(lm, self.caches)
            self._wave, self._reset = graph, graph.reset_slots
        else:
            self._wave, self._reset = lm.wave_step, lm.reset_slots
        self.waves = 0
        self.serve_stats = {"waves": 0, "prefill_waves": 0,
                            "decode_waves": 0, "admitted": 0, "finished": 0,
                            "slot_resets": 0, "queue_peak": 0,
                            "shed": 0, "expired": 0, "failed": 0,
                            "oob_prompt_tokens": 0, "wave_faults": 0,
                            "wave_retries": 0, "watchdog_timeouts": 0,
                            "capacity_rps_live": None,
                            "wave_graph": on_card and not staged,
                            "wave_graph_why": (
                                "gloo" if on_card and staged else
                                "cuda" if on_card else "not on the card")}
        # Ember steady-state path: the decode step's irregular lookups
        # compile once per (slots, 1) signature, and the executor's
        # marshaling cache is memoized alongside.
        self.emb_compiled = None
        self.emb_executor = None
        self.compile_stats: Optional[dict] = None
        if hasattr(lm, "embedding_program"):
            from ..core import executor as emb_exec
            from ..core import pipeline as emberc
            self._emberc = emberc
            self._emb_exec = emb_exec
            self.emb_executor = self._resolve_executor()
            self.emb_compiled = self.emb_executor.compiled
        self.pipeline_group = None
        if pipeline and hasattr(lm, "embedding_pipeline"):
            # the server's index policy flows into the member executors
            # (cache-keyed), so the pipeline hardens the mirrored streams
            # under the same policy as the prompts
            self.pipeline_group = lm.embedding_pipeline(
                batch_slots, 1, index_policy=index_policy, **self._svc_kw)
            if faults is not None:
                # group-level attach: cached member executors stay clean
                self.pipeline_group.faults = faults
            names = self.pipeline_group.names
            self._embed_name = names[0]
            self._undispatch_name = None
            if len(names) > 1:
                # the MoE un-dispatch member: a zero (E·C, D) capacity
                # buffer, as in the reference
                self._undispatch_name = names[1]
                op = self.pipeline_group.executor(names[1]) \
                    .compiled.program.op("moe_undispatch")
                self._cap_buf = torch.zeros(
                    (op.num_embeddings, op.emb_len),
                    dtype=lm.cfg.torch_dtype, device=lm.device)
                self._undisp_segments = op.num_segments
                self._undisp_rows = op.num_embeddings
        if self.emb_executor is not None:
            self.compile_stats = self._gather_compile_stats()

    def _resolve_executor(self):
        kw = dict(self._svc_kw)
        if self.artifact_dir is not None:
            kw["artifact_dir"] = self.artifact_dir
        if hasattr(self.lm, "embedding_executor"):
            return self.lm.embedding_executor(self.slots, 1, **kw)
        return self._emb_exec.executor_for(
            self.lm.embedding_program(self.slots, 1), **kw)

    def _gather_compile_stats(self) -> dict:
        s = self._emberc.compile_cache_stats()
        s["executor_cache"] = self._emb_exec.executor_cache_stats()
        s["executor"] = dict(self.emb_executor.stats)
        s["executor"]["backend"] = self.emb_executor.backend
        s["executor"]["shards"] = self.emb_executor.shards
        # which exchange moves the index streams and whether pooled
        # outputs are reduce-scattered or replicated
        s["executor"]["exchange"] = self.emb_executor.exchange
        s["executor"]["replicate_outputs"] = \
            self.emb_executor.replicate_outputs
        s["access_plans"] = self.emb_executor.access_plan_stats()
        if self.artifact_dir is not None:
            # where this boot's compile came from + the process's
            # load / save / reject counters
            from ..core.artifact import artifact_stats
            s["artifact"] = {
                "compile_source": self.emb_executor.compile_source,
                **artifact_stats()}
        if self.pipeline_group is not None:
            s["pipeline_group"] = self.pipeline_group.group_stats()
        return s

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        if not self._harden_prompt(req):
            return                       # terminal: failed (typed error)
        if self._shed_at_submit(req):
            return                       # terminal: shed (predicted wait)
        heapq.heappush(self.queue, (req.priority, next(self._seq), req))
        self.serve_stats["queue_peak"] = max(self.serve_stats["queue_peak"],
                                             len(self.queue))

    def _terminate(self, req: Request, status: str,
                   error: Optional[str] = None):
        """Retire a request that never reached a slot: stamp its terminal
        status -- the loop itself never dies for it."""
        req.status = status
        req.error = error
        req.done = True
        req.t_done = time.perf_counter()
        self.serve_stats[status if status != "ok" else "finished"] += 1

    def _harden_prompt(self, req: Request) -> bool:
        """Validate the prompt against the model vocab under
        ``index_policy``: strict -> the request fails (typed, terminal),
        clamp/drop -> repair and count.  Returns False when terminal."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        req.prompt = prompt
        if self._vocab is None:
            return True
        bad = (prompt < 0) | (prompt >= self._vocab)
        nbad = int(bad.sum())
        if nbad == 0:
            return True
        if self.index_policy == "strict":
            self._terminate(
                req, "failed",
                error=f"MalformedAccessError: {nbad} prompt token(s) "
                      f"outside [0, {self._vocab})")
            return False
        self.serve_stats["oob_prompt_tokens"] += nbad
        if self.index_policy == "clamp":
            req.prompt = np.clip(prompt, 0, self._vocab - 1)
            return True
        req.prompt = prompt[~bad]        # drop
        if req.prompt.size == 0:
            self._terminate(req, "failed",
                            error="MalformedAccessError: prompt empty "
                                  "after dropping out-of-bounds tokens")
            return False
        return True

    def _deadline(self, req: Request) -> Optional[float]:
        return req.deadline_s if req.deadline_s is not None \
            else self.ttft_slo_s

    def _shed_at_submit(self, req: Request) -> bool:
        """Predicted-wait shed: with a calibrated service capacity, a
        request that would wait out its whole TTFT budget in the queue is
        shed now."""
        d = self._deadline(req)
        if d is None or not self.capacity_rps:
            return False
        predicted_wait = len(self.queue) / self.capacity_rps
        if predicted_wait > d:
            self._terminate(req, "shed",
                            error=f"predicted queue wait "
                                  f"{predicted_wait:.3f}s > budget {d:.3f}s")
            return True
        return False

    def _predict_ttft_s(self, req: Request) -> float:
        """Service-time part of the TTFT prediction at admission: prefill
        waves needed x the measured wave EWMA (0 until a wave has run)."""
        if self._ewma_wave_s is None:
            return 0.0
        prefill_waves = max(
            1, -(-int(np.size(req.prompt)) // self.prefill_chunk))
        return prefill_waves * self._ewma_wave_s

    def _admit(self):
        """Fill every free slot from the priority heap -- at the top of each
        serving iteration and right after mid-wave retirement.  A popped
        request whose TTFT budget lapsed (``expired``) or cannot be met
        (``shed``) is retired here and the next one considered."""
        for i in range(self.slots):
            if self.active[i] is not None:
                continue
            while self.queue:
                _, _, req = heapq.heappop(self.queue)
                now = time.perf_counter()
                d = self._deadline(req)
                if d is not None:
                    waited = now - req.t_submit
                    if waited >= d:
                        self._terminate(req, "expired",
                                        error=f"TTFT budget {d:.3f}s "
                                              f"lapsed in queue")
                        continue
                    if waited + self._predict_ttft_s(req) > d:
                        self._terminate(
                            req, "shed",
                            error=f"predicted TTFT exceeds budget "
                                  f"{d:.3f}s at admission")
                        continue
                req.t_admit = now
                req.status = "active"
                req.admitted_wave = self.waves
                self.active[i] = req
                # leave >=1 position of room for generated tokens
                self._prompt_left[i] = np.asarray(
                    req.prompt, np.int32).reshape(-1)[:self.max_len - 1]
                self._pos[i] = 0
                self.serve_stats["admitted"] += 1
                break

    def _finish(self, i: int, req: Request, retired: np.ndarray,
                status: str = "ok", error: Optional[str] = None):
        req.status = status
        if error is not None:
            req.error = error
        req.done = True
        req.t_done = time.perf_counter()
        req.finished_wave = self.waves
        if req.admitted_wave is not None:
            self._req_wave_spans += max(
                1, req.finished_wave - req.admitted_wave + 1)
            self._req_span_count += 1
        retired[i] = True
        self.serve_stats[status if status != "ok" else "finished"] += 1

    def _recycle(self, retired: np.ndarray):
        """Mid-wave slot recycling: zero the retired slots' cache state and
        admit from the queue into them immediately."""
        if not retired.any():
            return
        self.caches = self._reset(self.caches, ~retired)
        self.serve_stats["slot_resets"] += int(retired.sum())
        for i in np.where(retired)[0]:
            self.active[i] = None
            self._prompt_left[i] = _EMPTY
            self._pos[i] = 0
        self._admit()

    # ------------------------------------------------------------------
    # Wave loop
    # ------------------------------------------------------------------

    def _feed_pipeline(self, tokens: np.ndarray):
        """Mirror this wave's access streams into the pipeline group in one
        ``submit_wave``: the decode-embed lookups of this wave (token embed
        and label gather over ``lm.embed``) and, for an MoE model, the
        un-dispatch gather over the capacity buffer with the reference's
        stream ``arange(segments) · (tok[0] + 1) mod rows``."""
        toks = np.ascontiguousarray(tokens[:, 0], np.int32)
        emb = self.lm.embed
        wave = {self._embed_name: {"tok_embed": {"table": emb, "idxs": toks},
                                   "label_gather": {"table": emb,
                                                    "idxs": toks}}}
        if self._undispatch_name is not None:
            idxs = (np.arange(self._undisp_segments, dtype=np.int64) *
                    (int(toks[0]) + 1)) % self._undisp_rows
            wave[self._undispatch_name] = {
                "moe_undispatch": {"table": self._cap_buf,
                                   "idxs": idxs.astype(np.int32)}}
        handles = self.pipeline_group.submit_wave(wave)
        if self.wave_deadline_s is not None:
            # the watchdog needs a bounded observation point: consume this
            # wave's handles now (only paid when a deadline is set)
            for h in handles.values():
                h.result()

    def step(self) -> int:
        """One serving iteration: admit -> one wave (chunked prefill and/or
        decode) -> retire + recycle + same-iteration admit.  Returns the
        number of active slots afterwards."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        c = self.prefill_chunk \
            if any(p.size for p in self._prompt_left) else 1
        tokens = np.zeros((self.slots, c), np.int32)
        lens = np.zeros(self.slots, np.int32)
        emits = np.zeros(self.slots, bool)   # slot emits a token this wave
        retired = np.zeros(self.slots, bool)
        for i, req in enumerate(self.active):
            if req is None:
                continue
            room = self.max_len - int(self._pos[i])
            left = self._prompt_left[i]
            if left.size:
                n = min(left.size, c, room)
                if n == 0:      # no cache room left mid-prompt: truncated
                    self._finish(i, req, retired)
                    continue
                tokens[i, :n] = left[:n]
                lens[i] = n
                self._prompt_left[i] = left[n:]
                emits[i] = self._prompt_left[i].size == 0
            else:
                if room <= 0:   # cannot place another token
                    self._finish(i, req, retired)
                    continue
                tokens[i, 0] = self._next_token[i]
                lens[i] = 1
                emits[i] = True
        if lens.sum() == 0:
            self._recycle(retired)
            return sum(r is not None for r in self.active)
        # --- the guarded wave body: LM step + pipeline feed, under the
        # watchdog deadline, retried after a typed fault ------------------
        t0 = time.perf_counter()
        lm_done = False     # the LM wave updates its caches: never re-run
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.fire("wave", wave=self.waves)
                if not lm_done:
                    logits, self.caches = self._wave(tokens, lens,
                                                     self.caches)
                    lm_done = True
                if self.pipeline_group is not None:
                    self._feed_pipeline(tokens)
                if self.wave_deadline_s is not None:
                    el = time.perf_counter() - t0
                    if el > self.wave_deadline_s:
                        raise WaveTimeout(
                            f"wave {self.waves} took {el * 1e3:.1f}ms > "
                            f"deadline {self.wave_deadline_s * 1e3:.1f}ms")
                break
            except EmberFault as e:
                # typed faults only: anything else is a bug and propagates
                self.serve_stats["wave_faults"] += 1
                if isinstance(e, WaveTimeout):
                    self.serve_stats["watchdog_timeouts"] += 1
                if self.pipeline_group is not None:
                    self.pipeline_group.reset()
                if attempt >= self.wave_retries:
                    # fail only the implicated requests (the slots served
                    # by this wave); their slots recycle, the loop lives
                    err = f"{type(e).__name__}: {e}"
                    for i, req in enumerate(self.active):
                        if req is None or retired[i]:
                            continue
                        self._finish(i, req, retired, status="failed",
                                     error=err)
                    self._recycle(retired)
                    return sum(r is not None for r in self.active)
                attempt += 1
                self.serve_stats["wave_retries"] += 1
                t0 = time.perf_counter()   # the retry gets a fresh budget
        dt = time.perf_counter() - t0
        self._ewma_wave_s = dt if self._ewma_wave_s is None else \
            0.7 * self._ewma_wave_s + 0.3 * dt
        # the wave's one synchronisation: the next tokens back to the host
        nxt = logits[:, 0].argmax(-1).cpu().numpy()
        self._pos += lens
        self.waves += 1
        self.serve_stats["waves"] += 1
        self.serve_stats["prefill_waves" if c > 1 else "decode_waves"] += 1
        if self.artifact_dir is not None and not self._artifact_saved \
                and self.emb_executor is not None:
            # first wave done: re-publish the artifact (idempotent)
            self._artifact_saved = True
            try:
                self.emb_executor.save_artifact()
            except OSError:
                pass                     # a failed save never fails a wave
        now = time.perf_counter()
        # mid-wave expiry: a slot still waiting on its first token whose
        # TTFT budget lapsed during service retires here (terminal)
        for i, req in enumerate(self.active):
            if req is None or retired[i] or req.t_first is not None:
                continue
            d = self._deadline(req)
            if d is not None and now - req.t_submit > d:
                self._finish(i, req, retired, status="expired",
                             error=f"TTFT budget {d:.3f}s lapsed in service")
        for i, req in enumerate(self.active):
            if req is None or retired[i] or not emits[i]:
                continue
            tok = int(nxt[i])
            req.out.append(tok)
            req.token_times.append(now)
            if req.t_first is None:
                req.t_first = now
            self._next_token[i] = tok
            if (self.eos is not None and tok == self.eos) or \
                    len(req.out) >= req.max_new_tokens or \
                    int(self._pos[i]) >= self.max_len:
                self._finish(i, req, retired)
        self._recycle(retired)
        # after the finish pass, so a drive whose requests all retire on
        # the final wave still arms the estimate before draining
        self._update_capacity()
        return sum(r is not None for r in self.active)

    def _update_capacity(self) -> None:
        """Live capacity estimate under ``capacity_rps="auto"``: sustained
        throughput ~ slots / (wave_s x avg waves-per-request), armed after
        the warmup wave count and at least one finished request."""
        if not self._capacity_auto or self._ewma_wave_s is None or \
                self.waves < self.capacity_warmup_waves or \
                not self._req_span_count:
            return
        avg_span = self._req_wave_spans / self._req_span_count
        est = self.slots / (self._ewma_wave_s * avg_span)
        self.capacity_rps = est
        self.serve_stats["capacity_rps_live"] = round(est, 2)

    def run_until_drained(self, max_steps: int = 100_000):
        steps = 0
        while (self.queue or
               any(r is not None for r in self.active)) and \
                steps < max_steps:
            self.step()
            steps += 1
        if self.pipeline_group is not None:
            self.pipeline_group.drain()
        if self.emb_executor is not None:
            self.compile_stats = self._gather_compile_stats()
        return steps
