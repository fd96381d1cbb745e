"""The MG-WFBP training engine (counterpart of ``repro/core/trainer.py``):
plan a merge schedule, then train with one all-reduce per schedule group.

Pipeline (paper Algorithm 2):

  1. cost     — per-unit gradient sizes and backward times (analytic,
                Eq. 18) from ``lm_unit_costs``;
  2. plan     — a ``planning.registry`` policy turns the cost vector into
                a frozen, JSON-serializable ``Plan``;
  3. execute  — ``make_train_step`` runs forward/backward and reduces the
                gradients with one all-reduce per group through
                ``core.sync``.

Two issue orders:

  * ``'post'`` — every group is reduced after ``loss.backward()``;
  * ``'dag'``  — the WFBP order: a ``register_post_accumulate_grad_hook``
    on each parameter counts its group down, and when a group's last
    gradient lands its pack and an asynchronous all-reduce go out at once,
    inside backward.  After backward the step waits on the handles in
    issue order, unpacks, and runs the optimizer.  The arithmetic is the
    same as ``'post'``, so the two give bitwise-equal parameters.

A parameter that the loss does not read gets an exact zero gradient, as
``jax.grad`` gives it: the embedding table of an untied embeds-input arch
(MusicGen, Qwen2-VL), whose batches bring their own embeddings.  Autograd
leaves its ``.grad`` None, so after backward the step fills a zero there and
counts it in, exactly as a gradient that landed would be (its ``dag`` group
and unit hooks fire then); the zero rides its group's all-reduce, and
AdamW's weight decay still moves the table, as in JAX.  Which parameters
those are is read from the config (``unread_params``), so a token arch's
step does no extra work.

The error-feedback residual (``compression='bf16_ef'``) is per-rank state
with no leading DP axis; the step keeps it and updates it in place, as it
updates ``param.grad`` (the reduced gradient is unpacked into it) and the
parameters.  A new step for a new plan (``MGWFBPEngine.replan``) takes
over the optimizer state and the residual of the one it replaces.

Given a ``core.profiler.TraceRecorder`` the step records its spans: each
group's all-reduce (``wfbp_group*``, see ``core.sync``) and backward —
one ``bwd_backward`` span under ``'post'``, and under ``'dag'`` one
``bwd_<unit>`` span per unit (``head``, ``tail``, ``stage{i}``,
``embed``), each from the previous unit's last gradient to its own.  A
recorder on the profiler's clock also gets the step's phases: ``step``
(the whole call, args ``step``: its index), ``forward`` (``model.loss``,
args ``tokens``), the sync's ``sync.pack`` / ``sync.wait`` /
``sync.unpack`` of each group (``core.sync``) and ``optimizer.update``
(args ``leaves`` and ``elements``), each mark a ``time.time_ns()`` on the
host as the step launches the work.  Without a recorder each site costs
one ``is None`` test.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..models.common import ArchConfig
from ..models.transformer import Transformer
from ..optim.optimizers import Optimizer, OptState
from ..planning import AnalyticCosts, CostSource, build_plan, replan_if_drifted, resolve_policy_name
from ..planning.plan import Plan
from .bucketing import stacked_lm_layout, tree_size
from .comm_model import AllReduceModel
from .cost_model import Hardware, LayerCost, TPU_V5E
from .schedule import Schedule
from .sync import GradientSync, PendingGroup, SyncConfig, make_gradient_sync


def unread_params(cfg: ArchConfig) -> tuple[str, ...]:
    """The parameters the training loss never reads: ``embed`` for an untied
    embeds-input arch, else none."""
    return ("embed",) if cfg.input_mode == "embeds" and not cfg.tie_embeddings else ()


def lm_unit_costs(
    cfg: ArchConfig,
    param_shapes: Any,
    tokens_per_device: int,
    hw: Hardware = TPU_V5E,
    comm_dtype_bytes: int = 4,
    model_shards: int = 1,
) -> list[LayerCost]:
    """Per-unit LayerCost for the stacked LM layout (paper Eq. 17/18).

    Units in paper order (gradient of unit 1 lands last):
    [embed, stage_1..stage_n, (tail), head+final_norm]."""
    embed_p = tree_size(param_shapes["embed"])
    stage_p = tree_size(param_shapes["stages"]) // cfg.n_stages
    norm_p = tree_size(param_shapes["final_norm"])
    head_p = norm_p + (0 if cfg.tie_embeddings else tree_size(param_shapes["head"]))
    tail_p = tree_size(param_shapes["tail"]) if "tail" in param_shapes else 0

    def cost(name, p, bwd, fwd):
        return LayerCost(
            name=name, params=p,
            grad_bytes=max(1, p * comm_dtype_bytes // model_shards),
            bwd_flops=bwd, fwd_flops=fwd,
        )

    t = tokens_per_device
    units = [cost("embed", embed_p, 2.0 * t * cfg.d_model, 2.0 * t * cfg.d_model)]
    active = 1.0
    if cfg.moe is not None:
        # only top-k of E experts run per token; the stage's attention is
        # dense, so the share is approximated as 1/4 dense + 3/4 routed
        active = cfg.moe.top_k / cfg.moe.n_experts
        active = 0.25 + 0.75 * active if active < 1 else 1.0
    for i in range(cfg.n_stages):
        units.append(cost(f"stage_{i}", stage_p, 4.0 * stage_p * t * active,
                          2.0 * stage_p * t * active))
    if tail_p:
        units.append(cost("tail", tail_p, 4.0 * tail_p * t, 2.0 * tail_p * t))
    head_flops_p = norm_p + cfg.d_model * cfg.vocab
    units.append(cost("head", head_p, 4.0 * head_flops_p * t, 2.0 * head_flops_p * t))
    return units


@dataclasses.dataclass
class MGWFBPEngine:
    """Plan + sync bundle for one (arch, process group) pair."""

    cfg: ArchConfig
    plan: Plan
    sync: GradientSync
    sync_config: SyncConfig = SyncConfig()
    group: dist.ProcessGroup | None = None

    @property
    def schedule(self) -> Schedule:
        return self.plan.schedule

    @property
    def stateful(self) -> bool:
        """True when the sync carries error-feedback state."""
        return self.sync_config.compression == "bf16_ef"

    def init_residual(self, model: torch.nn.Module) -> dict[str, torch.Tensor] | None:
        """Zero f32 error-feedback residual, one per parameter, or None for
        stateless compression.  Per-rank state: no leading DP axis."""
        if not self.stateful:
            return None
        return {
            n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in model.named_parameters()
        }

    @classmethod
    def build(
        cls,
        cfg: ArchConfig,
        param_shapes: Any,
        *,
        ar_model: AllReduceModel | None = None,
        tokens_per_device: int | None = None,
        policy: str | None = None,
        sync_config: SyncConfig = SyncConfig(),
        plan: Plan | None = None,
        group: dist.ProcessGroup | None = None,
    ) -> "MGWFBPEngine":
        """Build from an existing ``plan``, or plan from the analytic unit
        costs (against the reference's default ``TPU_V5E`` hardware model,
        so both packages pick the same schedule) and ``policy``."""
        if plan is not None and policy is not None:
            if resolve_policy_name(policy) != plan.policy:
                raise ValueError(
                    f"plan was built with policy {plan.policy!r}; drop the "
                    f"policy argument to reuse it, or re-plan with {policy!r}"
                )
        if plan is None:
            if ar_model is None:
                raise ValueError("either a plan or an ar_model is required")
            if tokens_per_device is None:
                raise ValueError("tokens_per_device is required for analytic costs")
            comm_bytes = sync_config.comm_dtype.itemsize if sync_config.compression is None else 2
            layout = stacked_lm_layout(param_shapes, cfg.n_stages, comm_dtype_bytes=comm_bytes)
            cost_source = AnalyticCosts(
                costs=tuple(
                    lm_unit_costs(cfg, param_shapes, tokens_per_device, comm_dtype_bytes=comm_bytes)
                ),
            )
            plan = build_plan(
                layout, cost_source.layer_costs(), ar_model,
                policy=policy or "mg_wfbp", hw=cost_source.hw,
                n_scan_stages=cfg.n_stages, cost_source=cost_source.name,
                provenance={"arch": cfg.name},
            )
        if plan.n_scan_stages not in (None, cfg.n_stages):
            raise ValueError(
                f"plan was built for {plan.n_scan_stages} stages, arch {cfg.name} has {cfg.n_stages}"
            )
        sync = make_gradient_sync(plan.layout, plan.schedule, sync_config, group)
        return cls(cfg=cfg, plan=plan, sync=sync, sync_config=sync_config, group=group)

    def with_plan(self, plan: Plan) -> "MGWFBPEngine":
        """Same engine, different plan (rebuilds the sync)."""
        return MGWFBPEngine.build(
            self.cfg, None, sync_config=self.sync_config, plan=plan, group=self.group
        )

    def replan(
        self,
        measured: CostSource,
        threshold: float = 0.15,
        policy: str | None = None,
    ) -> tuple["MGWFBPEngine", bool]:
        """Online re-planning hook: returns (engine, replanned).

        When measured costs drift beyond ``threshold`` the policy reruns
        and a new engine (new sync) is returned; the caller builds a new
        train step from it (handing over the optimizer state and residual).
        """
        new_plan, changed = replan_if_drifted(
            self.plan, measured, threshold=threshold, policy=policy
        )
        if not changed:
            return self, False
        return self.with_plan(new_plan), True

    def make_train_step(
        self,
        model: Transformer,
        optimizer: Optimizer,
        *,
        lr: float = 3e-4,
        issue: str = "post",
        residual: dict[str, torch.Tensor] | None = None,
        opt_state: OptState | None = None,
        recorder=None,
    ) -> "TrainStep":
        """``step(batch) -> {'loss': tensor}``, training ``model`` in place.

        ``residual`` seeds the error-feedback state (zeros when None) and
        ``opt_state`` the optimizer's (``optimizer.init`` when None): a step
        built for a new plan takes both over from the one it replaces.
        ``recorder`` (a ``core.profiler.TraceRecorder``) records the step's
        spans."""
        if issue not in ("post", "dag"):
            raise ValueError(f"unknown issue order {issue!r}; known: ('post', 'dag')")
        if self.stateful and residual is None:
            residual = self.init_residual(model)
        return TrainStep(self, model, optimizer, lr, issue, residual, opt_state, recorder)


class TrainStep:
    """One data-parallel MG-WFBP step over a model (see the module
    docstring).  Holds the optimizer state and, under ``bf16_ef``, the
    residual; ``close()`` removes the gradient hooks of the ``dag``
    order."""

    def __init__(self, engine: MGWFBPEngine, model: Transformer, optimizer: Optimizer,
                 lr: float, issue: str, residual: dict[str, torch.Tensor] | None,
                 opt_state: OptState | None = None, recorder=None):
        self.engine, self.model, self.optimizer = engine, model, optimizer
        self.lr, self.issue, self.residual = lr, issue, residual
        self.recorder = recorder
        self.params = dict(model.named_parameters())
        sync = engine.sync
        names = [n for g in sync.group_names for n in g]
        if sorted(names) != sorted(self.params):
            raise ValueError("the plan's wire entries do not cover the model's parameters")
        self.opt_state = optimizer.init(self.params) if opt_state is None else opt_state
        self._unread = unread_params(model.cfg)
        self._group_of = {n: gi for gi, g in enumerate(sync.group_names) for n in g}
        self._hooks = []
        self._pending: list[PendingGroup] = []
        self._remaining: list[int] = []
        if recorder is not None:  # the optimizer's counts, for its span
            self._opt_counts = {"leaves": len(self.params),
                                "elements": sum(p.numel() for p in self.params.values())}
        if issue == "dag":
            if recorder is not None:  # first, so a unit's span ends before its group packs
                self._add_unit_span_hooks()
            for gi, group_names in enumerate(sync.group_names):
                for n in group_names:
                    self._hooks.append(
                        self.params[n].register_post_accumulate_grad_hook(
                            lambda _p, gi=gi: self._grad_landed(gi)
                        )
                    )

    def _fill_unread(self) -> None:
        """After backward: an exact zero gradient for each parameter the loss
        does not read, counted in as a landed gradient (``dag``: its unit
        span and its group's countdown, which then packs and issues)."""
        for n in self._unread:
            p = self.params[n]
            if p.grad is not None:  # a token batch did read it: its hooks have fired
                continue
            p.grad = torch.zeros_like(p)
            if self.issue == "dag":
                if self.recorder is not None:
                    self._unit_grad_landed(self._unit_of(n))
                self._grad_landed(self._group_of[n])

    def _add_unit_span_hooks(self) -> None:
        """``dag`` under a recorder: one ``bwd_<unit>`` span per unit, in
        backward order, each ending when the unit's last gradient lands
        and the next one beginning there."""
        cfg = self.model.cfg
        unit_of = self._unit_of
        order = ["head"] + (["tail"] if cfg.tail_pattern else []) \
            + [f"stage{i}" for i in range(cfg.n_stages - 1, -1, -1)] + ["embed"]
        self._unit_order = order
        self._unit_size = {u: 0 for u in order}
        for n in self.params:
            self._unit_size[unit_of(n)] += 1
        for n, p in self.params.items():
            self._hooks.append(p.register_post_accumulate_grad_hook(
                lambda _p, u=unit_of(n): self._unit_grad_landed(u)))

    @staticmethod
    def _unit_of(name: str) -> str:
        head, *rest = name.split(".")
        if head == "stages":
            return f"stage{rest[0]}"
        return {"final_norm": "head"}.get(head, head)

    def _unit_grad_landed(self, unit: str) -> None:
        self._unit_left[unit] -= 1
        if self._unit_left[unit] == 0:
            dev = dist.get_rank(self.engine.group)
            self.recorder.span_end(f"bwd_{unit}", device=dev)
            k = self._unit_order.index(unit) + 1
            if k < len(self._unit_order):
                self.recorder.span_begin(f"bwd_{self._unit_order[k]}", device=dev)

    def _grad_landed(self, gi: int) -> None:
        """DAG hook: count group ``gi`` down; at zero, pack it and issue
        its all-reduce asynchronously."""
        self._remaining[gi] -= 1
        if self._remaining[gi] == 0:
            sync = self.engine.sync
            grads = {n: self.params[n].grad for n in sync.group_names[gi]}
            self._pending.append(sync.start_group(gi, grads, self.residual, async_op=True,
                                                  recorder=self.recorder))

    def _backward(self, loss: torch.Tensor) -> None:
        rec = self.recorder
        if rec is None:
            loss.backward()
            return
        dev = dist.get_rank(self.engine.group)
        if self.issue == "post":
            rec.span_begin("bwd_backward", device=dev)
            loss.backward()
            rec.span_end("bwd_backward", device=dev)
            return
        self._unit_left = dict(self._unit_size)
        rec.span_begin(f"bwd_{self._unit_order[0]}", device=dev)
        loss.backward()

    def __call__(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        sync, rec = self.engine.sync, self.recorder
        if rec is not None:
            dev = dist.get_rank(self.engine.group)
            rec.step_begin(device=dev)
        for p in self.params.values():
            p.grad = None
        self._pending = []
        self._remaining = [len(g) for g in sync.group_names]
        try:
            if rec is not None:
                rec.phase_begin("forward", device=dev, tokens=batch["targets"].numel())
            loss = self.model.loss(batch)
            if rec is not None:
                rec.phase_end("forward", device=dev)
            self._backward(loss)
            self._fill_unread()
            grads = {n: p.grad for n, p in self.params.items()}
            if self.issue == "post":
                for gi in range(sync.n_groups):
                    sync.sync_group(gi, grads, self.residual, recorder=rec)
            else:
                if len(self._pending) != sync.n_groups:
                    raise RuntimeError(
                        f"{len(self._pending)} of {sync.n_groups} groups were issued in backward"
                    )
                for pending in self._pending:  # issue order
                    sync.finish_group(pending, recorder=rec)
                self._pending = []
        except BaseException:
            # a step that fails mid-backward leaves no collective in flight
            # (a restore may follow): wait for the groups it issued
            for pending in self._pending:
                if pending.work is not None:
                    pending.work.wait()
            self._pending = []
            raise
        if rec is not None:
            rec.phase_begin("optimizer.update", device=dev, **self._opt_counts)
        self.optimizer.update(grads, self.opt_state, self.params, self.lr)
        if rec is not None:
            rec.phase_end("optimizer.update", device=dev)
        loss = loss.detach()
        world = sync.world()
        if world > 1:
            # the reported loss is the mean over ranks; it is not a gradient,
            # so it does not go through the counted issue() seam
            dist.all_reduce(loss, group=self.engine.group)
            loss = loss / world
        if rec is not None:
            rec.phase_end("step", device=dev)
        return {"loss": loss}

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


def batch_to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: token ids and targets int64,
    ``embeds`` f32."""
    return {k: torch.as_tensor(v, dtype=torch.float32 if k == "embeds" else torch.int64).to(device)
            for k, v in batch.items()}
