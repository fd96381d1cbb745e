"""Batch-slot serving engine: continuous batching over one captured decode
step (counterpart of ``repro/serving/engine.py``).

The engine owns a fixed batch of decode slots and keeps **all** per-step
state on the device in static buffers: the cache arena (``init_caches``
in f32), per-row positions, next tokens, the active-slot mask, the
per-row token budget and the sampled tokens.  The decode hot loop is one
step that runs the decode, the sampling, the masked position / budget /
token updates and the retirement mask, writing every buffer in place.  On
the card the step is **one CUDA graph**, captured once over those buffers
and replayed every step; joins and retirements write the buffers in
place (masked writes), never reallocate one, so they capture nothing new.
On the CPU the same step runs eagerly.  A capture that fails raises: the
engine never falls back to the eager step on its own (``cuda_graph=False``
asks for it, for comparisons).

Admission is bucketed as in the JAX engine: the requests admitted in one
step are prefilled one by one at their prompt lengths (the flash forward
on the card), and spliced into their slots lane by lane in a batch bucket
(a power of two up to ``slots``), with the JAX admit's leaf rule: stacked
stage leaves splice axis 1, slot-batched leaves axis 0, and the others
keep the engine's copy.  The prefill caches are bf16 (``make_prefill_step``'s
default, as the JAX step's) and are rounded so before they land in the
engine's f32 arena.

The JAX engine's semantics are kept exactly, including these:

- the decode step's scalar position is the largest active row position
  (the engine's clock), and every row decodes at it;
- the per-layer key positions ``kpos`` are one (T,) row shared by the
  batch, written by each decode step and kept by admission (the leaf rule
  above splices a prefill's ``kpos`` only where a leaf's leading size
  happens to equal ``slots``), so a decode step attends over the keys
  that decode steps wrote, as the JAX engine does (ROADMAP C);
- a joining request prefills its prompt, a resumed one (``generated``
  non-empty) ``prompt + generated[:-1]`` and continues from
  ``generated[-1]``;
- every row's recurrent state advances each step, active or not, and a
  join overwrites its slot's.

Kernel counters: a wrapper counts a launch where its Python runs, so the
capture's recording counts once and a replay, which runs the recorded
kernels with no Python, counts nothing.  ``decode_launches`` counts the
steps run on the device (replays, eager steps, warm-ups, probes) and
``graph_replays`` the replays among them; what a replay ran is read from
the device's own trace (``torch.profiler``), not from the counters.

An embeds-input arch (MusicGen, Qwen2-VL) is served through its stub
frontend, as in the JAX engine: token ids become rows of the model's own
embedding table in f32, at admission and inside the decode step (a gather
in the graph).  Its decode step passes the engine's clock as a device
tensor, so MusicGen's sinusoid is added at position 0 every step, as the JAX
engine's jitted step adds it (``models.transformer``; ROADMAP C).

Sampling is greedy (``argmax``) unless ``sample`` is given: ``sample(logits)``
or ``sample(logits, generator)``, the second drawing from an explicit
``torch.Generator`` that the engine seeds with ``sample_seed`` and
registers with the graph; a run repeats on the same seed (it is not held
to JAX's draws, which come from another generator).

Snapshots (``snapshot`` / ``restore_snapshot``, ``serving/resilience.py``)
copy the state to the host and back into the engine's own buffers, so a
restore captures nothing new.  ``prefills`` counts the prefills the engine
ran, fresh and resumed.

With ``mesh=`` (a ``DeviceMesh``, ``launch.mesh``) the engine *executes*
its plan: the decode step is ``serving.sharded``'s, run on the process
group of the mesh's ``tp_axis`` dimension, and issues exactly one
collective per scheduled serve group (KV all-gathers for dense archs,
expert all-to-alls for MoE), token for token the unsharded engine's.  On
the card the collectives are captured in the step's one CUDA graph, and
``install_plan`` rebuilds the step and captures it anew, once.  Every rank
of the group runs its own engine on the same requests (mirror-compute).
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from ..launch.steps import make_decode_step, make_prefill_step
from ..models.common import ArchConfig
from ..models.transformer import init_caches, tree_leaves, tree_map
from ..runtime.timeline import StepTimer

if TYPE_CHECKING:
    from ..planning.serve import ServePlan

@dataclasses.dataclass
class Request:
    """One generation request: a prompt, a token budget, and the tokens
    decoded so far.  ``submit`` it to a ``ServingEngine``; the engine
    appends to ``generated`` every step and sets ``done`` when the budget
    (or the engine's ``max_seq``) is reached.

    ``deadline_s`` (absolute, on the serving loop's clock), ``expired`` and
    ``shed`` belong to the resilient serve loop
    (``serving.resilience.resilient_serve_loop``), ``replica_id`` and
    ``retries`` to the fleet (``serving.fleet.FleetController``); the engine
    carries them unread.  A request submitted with a non-empty ``generated``
    list *resumes*: admission re-prefills ``prompt + generated[:-1]`` and
    continues decoding from ``generated[-1]``."""

    rid: int
    prompt: np.ndarray  # (prompt_len,) int32 token ids
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    deadline_s: float | None = None
    expired: bool = False
    shed: bool = False
    replica_id: int | None = None
    retries: int = 0

    @property
    def remaining_tokens(self) -> int:
        """Decode steps still owed to this request."""
        return max(0, self.max_new_tokens - len(self.generated))


class ServeTimer(StepTimer):
    """Decode-step wall-clock window (the JAX ``serving.sharded.ServeTimer``):
    the engine feeds ``observe(dt)`` per decode step (the first samples
    skipped), ``median()`` is the observed step time, and ``group_times``
    holds measured per-group collective seconds
    (``planning.serve.time_serve_groups``).  ``prefill_times`` holds each admission's
    prefill seconds (device synchronized), beside the decode steps."""

    def __init__(self, window: int = 200, skip_first: int = 2):
        super().__init__(window=window, skip_first=skip_first)
        self.group_times: tuple[float, ...] = ()
        self.prefill_times: list[float] = []


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The default sampler: the first index of each row's largest logit."""
    return torch.argmax(logits, dim=-1)


def gumbel_sampler(temperature: float) -> Callable:
    """A keyed sampler ``(logits, generator) -> tokens`` drawing from
    ``softmax(logits / temperature)`` by the Gumbel-max trick (no host
    synchronisation, so it runs inside a CUDA graph)."""

    def sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(logits / temperature + gumbel, dim=-1)

    return sample


def _takes_key(sample: Callable) -> bool:
    """Whether ``sample`` is the keyed two-argument form."""
    try:
        return len(inspect.signature(sample).parameters) >= 2
    except (TypeError, ValueError):
        return False


def _copy_state(state: dict) -> dict:
    return tree_map(torch.clone, state)


def _put_row(c: torch.Tensor, f: torch.Tensor, s: int, valid: bool, axis: int) -> None:
    """The JAX admit's masked write of one lane: ``where(valid, f, c[s])``
    broadcast, written at ``s`` along ``axis`` with ``dynamic_update_slice``'s
    clamped start."""
    cur = c.narrow(axis, s, 1).clone()
    shape = torch.broadcast_shapes(f.shape, cur.shape)
    row = (f.to(c.dtype) if valid else cur).expand(shape)
    start = min(s, c.shape[axis] - shape[axis])
    c.narrow(axis, start, shape[axis]).copy_(row)


class ServingEngine:
    """Synchronous-step continuous batching over fixed decode slots.

    ``model`` is a ``models.Transformer`` (its device is the engine's);
    ``plan`` the decode-side ``planning.ServePlan`` the engine runs under:
    advisory without a mesh (predictions; an unsharded engine executes no
    collective), executed with ``mesh=`` over the group of its ``tp_axis``
    dimension (a plan is then required).  ``cuda_graph`` defaults to True on the card and False on
    the CPU.  A ``ServeTimer`` passed as ``timer=`` records each step's
    wall clock (device synchronized), closing the predicted-vs-observed
    loop; call ``warmup()`` first so the capture is never timed.

    Example::

        plan = build_serve_plan(cfg, param_shapes(cfg), "gpu_nccl",
                                {"model": 8}, batch_rows=4)
        eng = ServingEngine(cfg, model, slots=4, plan=plan)
        eng.warmup()
        plan = eng.calibrate_plan()
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=16))
        done = eng.run_to_completion()
    """

    @torch.inference_mode()
    def __init__(self, cfg: ArchConfig, model, *, slots: int = 4, max_seq: int = 512,
                 sample: Callable | None = None, sample_seed: int = 0,
                 plan: "ServePlan | None" = None, mesh=None, tp_axis: str = "model",
                 timer: ServeTimer | None = None, cuda_graph: bool | None = None):
        if mesh is not None and plan is None:
            raise ValueError("sharded serving (mesh=) requires a ServePlan")
        self.cfg, self.model = cfg, model
        self.slots, self.max_seq = slots, max_seq
        self.plan, self.timer = plan, timer
        self.device = model.embed.device
        self.cuda_graph = self.device.type == "cuda" if cuda_graph is None else cuda_graph
        if self.cuda_graph and self.device.type != "cuda":
            raise ValueError("cuda_graph=True needs the model on the card")
        self.sample = sample or greedy
        self._keyed_sample = _takes_key(self.sample)
        self._prefill = make_prefill_step(cfg, max_seq)
        self.mesh, self.tp_axis = mesh, tp_axis
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the model on {self.device.type}")
        self._decode = self._make_decode()
        dev = self.device
        self._state = {
            "caches": init_caches(cfg, slots, max_seq, dtype=torch.float32, device=dev),
            "row_pos": torch.zeros(slots, dtype=torch.int32, device=dev),
            "next_token": torch.zeros(slots, dtype=torch.int32, device=dev),
            "active": torch.zeros(slots, dtype=torch.bool, device=dev),
            "budget": torch.zeros(slots, dtype=torch.int32, device=dev),
        }
        self._embeds = cfg.input_mode == "embeds"
        self._sampled = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(sample_seed)
        self._admit_gen = torch.Generator(device=dev).manual_seed(sample_seed + 1)
        self._graph: torch.cuda.CUDAGraph | None = None
        self.graph_captures = 0
        self.graph_replays = 0
        self.decode_launches = 0  # decode steps run on the device: steps, warm-ups, probes
        self._eager_built = False
        self._admit_buckets: set[int] = set()
        self._prefill_lengths: set[int] = set()
        self.prefills = 0  # prefills run, fresh and resumed
        self.active: dict[int, Request] = {}  # slot -> request
        self.row_pos = np.zeros((slots,), np.int32)  # host mirrors (bookkeeping)
        self.next_token = np.zeros((slots,), np.int32)
        self.waiting: list[Request] = []
        self.completed: list[Request] = []

    # -- the one step ------------------------------------------------------

    def _make_decode(self) -> Callable:
        """``decode(model, caches, batch, pos) -> (logits, caches, wire)``:
        the plan-driven sharded step with a mesh, else the plain decode
        (``wire`` empty)."""
        if self.mesh is not None:
            from ..planning.serve import axis_group
            from .sharded import make_sharded_decode_step

            return make_sharded_decode_step(self.cfg, self.plan,
                                            axis_group(self.mesh, self.tp_axis))
        base = make_decode_step(self.cfg)

        def decode(model, caches, batch, pos):
            logits, caches = base(model, caches, batch, pos)
            return logits, caches, ()

        return decode

    def _body(self, state: dict, sampled_out: torch.Tensor) -> None:
        """Decode + sample + masked state updates, in place on ``state``
        (what the graph captures)."""
        active, row_pos, budget = state["active"], state["row_pos"], state["budget"]
        pos = torch.where(active, row_pos, 0).max()
        logits, _, _ = self._decode(self.model, state["caches"],
                                    self._step_input(state["next_token"][:, None]), pos)
        if self._keyed_sample:
            sampled = self.sample(logits, self._gen)
        else:
            sampled = self.sample(logits)
        sampled = sampled.to(torch.int32)
        new_pos = torch.where(active, row_pos + 1, row_pos)
        new_budget = torch.where(active, budget - 1, budget)
        # retirement is a masked write: a row leaves the batch by its mask bit
        still = active & (new_budget > 0) & (new_pos + 1 < self.max_seq)
        state["next_token"].copy_(torch.where(active, sampled, state["next_token"]))
        row_pos.copy_(new_pos)
        budget.copy_(new_budget)
        active.copy_(still)
        sampled_out.copy_(sampled)

    def _capture(self) -> None:
        """Capture the step once over the engine's buffers: a warm-up run
        on a copy of the state (on a side stream, as capture wants), then
        the capture itself."""
        scratch, scratch_out = _copy_state(self._state), self._sampled.clone()
        scratch["active"].fill_(True)
        gen_state = self._gen.get_state()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._body(scratch, scratch_out)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.decode_launches += 1
        self._gen.set_state(gen_state)
        del scratch, scratch_out
        graph = torch.cuda.CUDAGraph()
        if self._keyed_sample:
            graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph):
            self._body(self._state, self._sampled)
        self._graph = graph
        self.graph_captures += 1

    def _launch_step(self) -> None:
        """One decode step on the engine's buffers: the graph's replay on
        the card, the eager body elsewhere (or with ``cuda_graph=False``)."""
        if self.cuda_graph:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            self.graph_replays += 1
        else:
            self._body(self._state, self._sampled)
            self._eager_built = True
        self.decode_launches += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- predicted vs observed --------------------------------------------

    def predicted_step_time(self) -> float | None:
        """Modeled decode-step seconds: the plan's wire timeline plus its
        ``t_step_fixed`` term."""
        return self.plan.predicted_step_time() if self.plan is not None else None

    def observed_step_time(self) -> float | None:
        """Median measured decode-step seconds from the attached
        ``ServeTimer`` (None without one or before a clean sample)."""
        return self.timer.median() if self.timer is not None else None

    @torch.inference_mode()
    def warmup(self) -> None:
        """Build the step before anything is timed: capture the graph (its
        warm-up runs on a copy of the state), or run the eager step once on
        a copy with every slot active.  The engine's state and requests are
        untouched."""
        if self.cuda_graph:
            if self._graph is None:
                self._capture()
            return
        scratch = _copy_state(self._state)
        scratch["active"].fill_(True)
        gen_state = self._gen.get_state()
        self._body(scratch, self._sampled.clone())
        self._gen.set_state(gen_state)
        self._eager_built = True
        self.decode_launches += 1

    @torch.inference_mode()
    def probe_step_time(self, repeats: int = 5) -> float:
        """Min-of-``repeats`` wall seconds of the engine's step with every
        slot active (device synchronized around each), via the shared
        outlier-retrying ``planning.costs.min_of_k`` (rank 0's samples on
        every rank of a sharded engine's group).  It runs on the
        engine's own buffers (the graph is bound to them), which are saved
        first and put back after, with the sampler's generator."""
        from ..planning.costs import min_of_k, rank0_values
        from ..planning.serve import axis_group

        # a sharded step issues collectives: every rank of the group takes
        # rank 0's samples, so that all retry alike and make the same calls
        group = None if self.mesh is None else axis_group(self.mesh, self.tp_axis)
        saved, gen_state = _copy_state(self._state), self._gen.get_state()
        try:
            self._state["active"].fill_(True)
            self._launch_step()  # warm
            self._sync()

            def sample() -> float:
                t0 = time.perf_counter()
                self._launch_step()
                self._sync()
                t = time.perf_counter() - t0
                return t if group is None else rank0_values([t], group, self.device)[0]

            return min_of_k(sample, max(1, repeats))
        finally:
            for dst, src in zip(tree_leaves(self._state), tree_leaves(saved)):
                dst.copy_(src)
            self._gen.set_state(gen_state)

    def measure_step_fixed(self, repeats: int = 5) -> float:
        """The per-step fixed seconds: the probed whole step minus the
        plan's wire timeline (the whole probe without a plan)."""
        probe = self.probe_step_time(repeats=repeats)
        wire = 0.0
        if self.plan is not None and self.plan.schedule.result is not None:
            wire = self.plan.schedule.result.t_iter
        return max(0.0, probe - wire)

    def calibrate_plan(self, repeats: int = 5) -> "ServePlan":
        """Probe the fixed term and install (and return) the calibrated
        plan: ``predicted_step_time`` then reports wire + fixed."""
        if self.plan is None:
            raise ValueError("calibrate_plan requires a ServePlan")
        self.plan = self.plan.with_step_fixed(self.measure_step_fixed(repeats))
        return self.plan

    def install_plan(self, plan: "ServePlan") -> None:
        """Swap in a (re)built ``ServePlan``.  An unsharded engine executes
        no collective, so the step is unchanged and nothing is captured.  A
        sharded engine's step executes the plan's merge schedule, so it is
        rebuilt, and on the card captured anew at the next step (once: the
        only way the wire changes shape)."""
        self.plan = plan
        if self.mesh is not None:
            self._decode = self._make_decode()
            self._graph = None

    @torch.inference_mode()
    def retire(self, slot: int, *, expired: bool = False, requeue: bool = False) -> Request:
        """Retire an active row before its budget is spent: the request
        keeps its partial ``generated``, the slot's mask bit flips off (a
        write into the graph's buffer), and the slot frees.  With
        ``requeue`` the request is evicted, returned not done and put in no
        queue; otherwise it lands in ``completed`` (``expired`` marks a
        deadline expiry)."""
        req = self.active.pop(slot)
        self._state["active"][slot] = False
        if requeue:
            return req
        req.done = True
        req.expired = expired
        self.completed.append(req)
        return req

    def drain_requests(self) -> list[Request]:
        """Evict every in-flight and waiting request (active rows first, in
        slot order), each with its partial ``generated``; the engine is
        left empty."""
        out = [self.retire(slot, requeue=True) for slot in sorted(self.active)]
        out.extend(self.waiting)
        self.waiting.clear()
        return out

    # -- snapshot / restore -------------------------------------------------

    def snapshot(self, step: int = 0) -> Any:
        """A host-side ``EngineSnapshot`` of the decode state (the cache
        tree, row positions, next tokens, mask, budgets), both sampling
        generators' states, the host mirrors and the request queues
        (``serving.resilience.snapshot_engine``).  Persist it with
        ``serving.resilience.write_snapshot``; ``restore_snapshot`` resumes
        decoding token for token."""
        from .resilience import snapshot_engine

        return snapshot_engine(self, step)

    @torch.inference_mode()
    def restore_snapshot(self, snap: Any) -> None:
        """Install an ``EngineSnapshot`` taken from an engine of the same
        arch, slots and max_seq (checked, with every tensor's shape and
        dtype, before anything is written): the state is copied into the
        engine's own tensors, never rebound, so a captured graph replays
        over the restored values and nothing is captured anew; both
        generators take their saved states; the request queues and host
        mirrors are rebuilt.  The next ``step()`` continues where the
        snapshot left off."""
        from .resilience import requests_from_snapshot

        snap.validate_against(self)
        dst, src = tree_leaves(self._state), tree_leaves(snap.state)
        if [(d.shape, d.dtype) for d in dst] != [(s.shape, s.dtype) for s in src]:
            raise ValueError("snapshot state does not have the engine's shapes and dtypes")
        for d, s in zip(dst, src):
            d.copy_(s)
        self._gen.set_state(snap.gen_state)
        self._admit_gen.set_state(snap.admit_gen_state)
        self.active, self.waiting, self.completed = requests_from_snapshot(snap)
        self.row_pos = np.asarray(snap.row_pos, np.int32).copy()
        self.next_token = np.asarray(snap.next_token, np.int32).copy()

    def compile_stats(self) -> dict[str, Any]:
        """Programs built per entry point, as the JAX engine counts
        executables: ``decode`` (the step: its CUDA graph captures on the
        card, 1 once the eager step has run elsewhere), ``admit`` (one per
        batch bucket used; admission runs eagerly and captures nothing),
        ``prefill`` (one per distinct prompt length), and
        ``graph_captures``.  The steady-state invariant is ``decode == 1``
        across joins, leaves and slot reuse."""
        decode = self.graph_captures if self.cuda_graph else int(self._eager_built)
        return {
            "decode": decode,
            "admit": {m: 1 for m in sorted(self._admit_buckets)},
            "prefill": len(self._prefill_lengths),
            "graph_captures": self.graph_captures,
        }

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _bucket(self, k: int) -> int:
        """Static admission bucket: next power of two >= k, <= slots."""
        m = 1 << max(0, k - 1).bit_length()
        return min(m, self.slots)

    def _step_input(self, ids: torch.Tensor) -> dict:
        """The forward's input for token ids (B, S): the ids, or for an
        embeds-input arch the stub frontend's embeddings, the model's own
        table rows in f32 (the JAX engine's ``params['embed'][ids]``),
        gathered on the device (inside the graph, in a decode step)."""
        if self._embeds:
            return {"embeds": self.model.embed[ids.long()].float()}
        return {"tokens": ids}

    def _prefill_ids(self, ids: np.ndarray):
        self._prefill_lengths.add(len(ids))
        self.prefills += 1
        tokens = torch.as_tensor(np.asarray(ids)[None, :], dtype=torch.long, device=self.device)
        if self.timer is None:
            return self._prefill(self.model, self._step_input(tokens))
        self._sync()
        t0 = time.perf_counter()
        out = self._prefill(self.model, self._step_input(tokens))
        self._sync()
        self.timer.prefill_times.append(time.perf_counter() - t0)
        return out

    def _splice(self, entries: list, valid: list[bool]) -> None:
        """The JAX bucketed admit, lane by lane, in place: each lane's
        1-row prefill caches into its slot (by the leaf rule of the module
        docstring) and its per-row scalars."""
        n_stages, slots = self.cfg.n_stages, self.slots
        fresh = [tree_leaves(e[1]) for e in entries]
        for li, c in enumerate(tree_leaves(self._state["caches"])):
            for i, e in enumerate(entries):
                f, s = fresh[i][li], e[0]
                if c.dim() >= 3 and c.shape[0] == n_stages and c.shape[1] == slots:
                    _put_row(c, f, s, valid[i], axis=1)
                elif c.dim() >= 1 and c.shape[0] == slots:
                    _put_row(c, f, s, valid[i], axis=0)
        st = self._state
        for i, (s, _, tok, pos0, budget0) in enumerate(entries):
            if valid[i]:
                st["row_pos"][s] = pos0
                st["next_token"][s] = tok
                st["budget"][s] = budget0
                st["active"][s] = True

    def _admit(self) -> None:
        free = [s for s in range(self.slots) if s not in self.active]
        entries: list[tuple[int, dict, int, int, int]] = []
        while free and self.waiting:
            slot = free.pop(0)
            req = self.waiting.pop(0)
            if req.generated:
                # resume: re-prefill up to the last sampled token, decode it next
                if req.remaining_tokens == 0:
                    req.done = True
                    self.completed.append(req)
                    free.insert(0, slot)
                    continue
                ids = np.concatenate([np.asarray(req.prompt, np.int32),
                                      np.asarray(req.generated[:-1], np.int32)])
                _, fresh = self._prefill_ids(ids)
                tok = int(req.generated[-1])
                pos0 = len(req.prompt) + len(req.generated) - 1
            else:
                logits, fresh = self._prefill_ids(np.asarray(req.prompt, np.int32))
                if self._keyed_sample:
                    tok = int(self.sample(logits, self._admit_gen)[0])
                else:
                    tok = int(self.sample(logits)[0])
                req.generated.append(tok)
                pos0 = len(req.prompt)
            self.active[slot] = req
            self.row_pos[slot] = pos0
            self.next_token[slot] = tok
            entries.append((slot, fresh, tok, pos0, req.max_new_tokens - len(req.generated)))
        if not entries:
            return
        n_real = len(entries)
        m = self._bucket(n_real)
        while len(entries) < m:  # pad the bucket with masked-off lanes
            entries.append(entries[0])
        self._admit_buckets.add(m)
        self._splice(entries, [i < n_real for i in range(m)])

    # -- stepping ----------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> int:
        """Admit, decode one token for every active row; returns the number
        of rows still active.  With no active row this does nothing: no
        capture, no launch."""
        self._admit()
        if not self.active:
            return 0
        t0 = time.perf_counter() if self.timer is not None else 0.0
        self._launch_step()
        if self.timer is not None:
            self._sync()
            self.timer.observe(time.perf_counter() - t0)
        sampled = self._sampled.cpu().numpy()  # the step's one device->host read
        for slot, req in list(self.active.items()):
            tok = int(sampled[slot])
            req.generated.append(tok)
            self.row_pos[slot] += 1
            self.next_token[slot] = tok
            if len(req.generated) >= req.max_new_tokens or self.row_pos[slot] + 1 >= self.max_seq:
                req.done = True
                self.completed.append(req)
                del self.active[slot]
        return len(self.active)

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        """Step until no request is active or waiting; the completed
        requests, in completion order."""
        for _ in range(max_steps):
            if not self.active and not self.waiting:
                break
            self.step()
        return self.completed
