"""Posterior-predictive serving engine: continuous batching over a fixed
slot axis, Bayesian model averaging over K ensemble members, and live
snapshot refresh from the coupled sampler.

Every tick decodes all slots through each of the K members (a loop over
members; each member decodes the whole slot axis in one batched call),
mixes the K logit rows per slot, and selects one token per slot.  Slot
state that changes as requests join and finish (tokens, done masks,
budgets, block tables, context lengths) is data; shapes never change.
Done/free slots keep computing; their emissions are masked to ``pad_id``.

``paged=True`` swaps the dense per-slot stripes for the block-paged pool:
block tables and context lengths are copied to the device every tick,
admission additionally gates on the page allocator's worst-case
reservation, and done-slot writes are redirected to the reserved sink page
0 so recycled pages can never be corrupted mid-batch.  ``fused_select``
routes the mixture + selection through the bma_select kernel (on by default
on CUDA); its Gumbel draw is the same as the unfused path's, so tokens are
bit-identical given the same mixture.

Sampling randomness comes from ``torch.Generator``s reseeded per decode
tick and per admitted request from (``seed``, stream, index), mirroring
the reference's ``fold_in`` keys: a tick's draw does not depend on history.

``refresher`` (a ``ChainRefresher`` or the overlapped ``RefreshScheduler``
feeding the same registry) is bound at construction and pumped once per
tick before the decode; promotions rebind the registry's members and take
effect at the next member read.

``mesh`` (a 2-D ``(member, slot)`` ``DeviceMesh``, ``launch.mesh.
make_engine_mesh``) shards the engine over ``torch.distributed`` ranks,
SPMD: every rank runs the same FCFS queue, slot acquisition, block tables
and tick clock, which are deterministic on the host, so no collective is
needed to agree on them.  By the layout rule (``distributed.sharding.
leading_axes_specs``) a rank holds the K/W_m members of its member shard
and, on the dense engine, the cache stripes of its slot block; a dim an
axis does not divide replicates, and the paged engine's slot axis always
replicates (pages are shared across slots by prefix sharing, so every rank
of a member shard decodes every slot).  A tick decodes the local members
over the local slots, all-gathers the (K_local, S_local, V) logits over
the member axis, mixes and selects on the rank's slots (its rows of the
unsharded engine's Gumbel draw), and all-gathers the tick's emit, feed,
done and budget (and logp under ``record_logprobs``) over the slot axis,
so every host sees all S slots.  An admit prefills through the local
members and all-gathers the last position's logits over the member axis;
only the slot's block writes its stripe.  Each collective runs where the
rule grants its axis, on a one-rank mesh too, and is counted
(``distributed.collective_counts``).

``compress_parked`` parks idle slots through the int8
codec.  The reference pins that decode is ONE compiled
program; eager PyTorch has no counterpart of that pin (capturing the tick
in a CUDA graph would be), so ``trace_counts`` here counts decode calls
and admits per prompt length.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import leading_axes_specs, local_block
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.sampling import GREEDY, SamplingParams, gumbel_noise, select_tokens

from .bma import BMA_MODES, fused_mixture_select, mixture_logprobs
from .cache_pool import CachePool, PagedCachePool
from .registry import ChainRefresher, SnapshotRegistry
from .scheduler import FCFSQueue, Request, RequestResult

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit generator seed for (seed, stream, index): splitmix64 of the
    combined counter."""
    x = (seed * 0x9E3779B97F4A7C15 + stream * 0xD1B54A32D192ED03 + index + 1) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x >> 1


@dataclass
class _Active:
    result: RequestResult
    submit_s: float
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)


@dataclass
class ServeReport:
    """Aggregate outcome of one ``ServeEngine.run``: per-request results +
    the latency/throughput numbers."""

    results: list
    wall_s: float
    decode_steps: int
    total_tokens: int
    trace_counts: dict
    pool: dict
    registry: dict
    refresher: dict | None

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-12)

    def latency_percentiles(self) -> dict:
        """p50/p99 of request completion latency and first-token latency
        (seconds, queueing included)."""
        lat = np.asarray([r.latency_s for r in self.results], np.float64)
        ftl = np.asarray([r.first_token_s for r in self.results], np.float64)
        pct = lambda a, q: float(np.percentile(a, q)) if a.size else float("nan")
        return {
            "latency_p50_s": pct(lat, 50),
            "latency_p99_s": pct(lat, 99),
            "first_token_p50_s": pct(ftl, 50),
            "first_token_p99_s": pct(ftl, 99),
        }


class ServeEngine:
    """Continuous-batching BMA decode over a pooled slot axis.

    ``members``: a (K, ...)-stacked parameter dict or a
    :class:`SnapshotRegistry`, already on ``device`` (nothing is moved;
    under a ``mesh`` the registry keeps the rank's block of each stack).
    ``refresher`` (optional, a :class:`ChainRefresher` or an overlapped
    :class:`~repro_torch.serve.engine.refresh.RefreshScheduler` feeding the
    same registry) is bound at construction and pumped EVERY decode tick;
    it amortizes one sampler chunk per ``refresh_every`` ticks — stale
    members serve until the registry promotes a candidate that passes the
    spread gate.
    """

    def __init__(
        self,
        cfg,
        model,
        members,
        *,
        num_slots: int,
        max_seq: int,
        sampling: SamplingParams = GREEDY,
        bma: str = "probs",
        eos_id: int | None = None,
        pad_id: int = 0,
        cache_dtype=None,
        refresher: ChainRefresher | None = None,
        refresh_every: int = 0,
        compress_parked: bool = False,
        record_logprobs: bool = False,
        seed: int = 0,
        mesh=None,
        member_axis: str = "member",
        slot_axis: str = "slot",
        paged: bool = False,
        block_size: int = 16,
        num_blocks: int | None = None,
        prefix_sharing: bool = True,
        fused_select: bool | None = None,
        device="cuda",
    ):
        if bma not in BMA_MODES:
            raise ValueError(f"bma must be one of {BMA_MODES}")
        self.device = torch.device(device)
        self.cfg, self.model = cfg, model
        self.registry = members if isinstance(members, SnapshotRegistry) else SnapshotRegistry(members)
        for leaf in tree_leaves(self.registry.members):
            if leaf.device.type != self.device.type:
                raise ValueError(f"members live on {leaf.device}, engine runs on {self.device}")
        self.sampling = sampling
        self.bma = bma
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.max_seq = int(max_seq)
        self.cache_dtype = cache_dtype
        self.refresher = refresher
        self.refresh_every = int(refresh_every)
        if refresher is not None and refresher.registry is not self.registry:
            raise ValueError("refresher must feed this engine's registry")
        self._seen_version = self.registry.version
        self.record_logprobs = bool(record_logprobs)
        self.paged = bool(paged)
        self.mesh = mesh
        self._layout(mesh, member_axis, slot_axis, int(num_slots))
        # the fused mixture+selection kernel is on by default where it is a
        # real kernel (CUDA); the CPU runs its plain version either way
        self._fused_select = (
            self.device.type == "cuda" if fused_select is None else bool(fused_select)
        )
        pool_kw = dict(num_members=self._k_local, num_slots=num_slots,
                       max_seq=max_seq, dtype=cache_dtype or cfg.compute_dtype,
                       compress_parked=compress_parked, device=self.device)
        if self.paged:
            self.pool = PagedCachePool(cfg, model, block_size=block_size, num_blocks=num_blocks,
                                       prefix_sharing=prefix_sharing, **pool_kw)
        else:
            self.pool = CachePool(cfg, model, slot_block=self._slots, **pool_kw)
        S = self.pool.num_slots
        self._tokens = torch.full((S, 1), self.pad_id, dtype=torch.int32, device=self.device)
        self._done = torch.ones((S,), dtype=torch.bool, device=self.device)
        self._budget = torch.zeros((S,), dtype=torch.int32, device=self.device)
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self.trace_counts: Counter = Counter()
        self.decode_steps = 0
        if mesh is not None:  # the rank's block of the members, from here on
            self.registry.members = self._place_members(self.registry.members)
        self._placed_version = self.registry.version
        if refresher is not None and hasattr(refresher, "bind"):
            # pacing, placement and warm-up happen here, at construction —
            # never on a serving request
            refresher.bind(self)

    def _layout(self, mesh, member_axis, slot_axis, num_slots) -> None:
        """This rank's block under ``mesh`` by the layout rule: the member
        axis (``_ax_member``, ``_k_local`` members) and, on
        the dense engine, the slot axis (``_ax_slot``, slot ids
        ``_slots``); None where the axis replicates.  ``host`` binds every
        rank of the mesh on a gloo group (the refresher's agreement)."""
        K = self.registry.num_members
        self._ax_member = self._ax_slot = self.host = None
        self._k_local, self._slots = K, (0, num_slots)
        if mesh is None:
            return
        if not tuple(getattr(mesh, "mesh_dim_names", None) or ()):
            raise ValueError(f"mesh must be a DeviceMesh with named axes, got {mesh!r}")
        self._member_specs = leading_axes_specs(self.registry.members, (member_axis,), mesh)
        m_ax, s_ax = leading_axes_specs(torch.empty((K, num_slots), device="meta"),
                                        (member_axis, slot_axis), mesh)
        if m_ax is not None:
            self._ax_member = collectives.mesh_axis(mesh, m_ax)
            self._k_local = K // self._ax_member.size
        if s_ax is not None and not self.paged:
            self._ax_slot = collectives.mesh_axis(mesh, s_ax)
            n = num_slots // self._ax_slot.size
            self._slots = (self._ax_slot.rank * n, (self._ax_slot.rank + 1) * n)
        self.host = collectives.host_world(mesh)

    def _gather_members(self, x):
        """(K_local, ...) per-member rows -> (K, ...) in member order: one
        all-gather over the member axis (none where it replicates)."""
        if self._ax_member is None:
            return x
        return collectives.all_gather(x, self._ax_member).reshape((-1,) + tuple(x.shape[1:]))

    def _gather_slots(self, emit, feed, done, budget, logp):
        """The tick's slot state of this rank's slots -> all S slots: one
        all-gather over the slot axis of the four int32 columns (and the
        logp rows' bits under ``record_logprobs``); none where the axis
        replicates."""
        if self._ax_slot is None:
            return emit, feed, done, budget, logp
        cols = [torch.stack([emit, feed[:, 0], done.to(torch.int32), budget], dim=1)]
        if self.record_logprobs:
            cols.append(logp.contiguous().view(torch.int32))
        packed = torch.cat(cols, dim=1)
        g = collectives.all_gather(packed, self._ax_slot).reshape(-1, packed.shape[1])
        logp = g[:, 4:].contiguous().view(torch.float32) if self.record_logprobs else None
        return g[:, 0].clone(), g[:, 1:2].clone(), g[:, 2].bool(), g[:, 3].clone(), logp

    # -- members ---------------------------------------------------------------

    def _members(self):
        """Registry members in the engine's placement.  Promotions from any
        source (overlapped scheduler, sync ChainRefresher, manual propose)
        are placed once per registry version; the overlapped flip places
        and marks, making this a no-op."""
        if self._placed_version != self.registry.version:
            self.registry.members = self._place_members(self.registry.members)
            self._placed_version = self.registry.version
        return self.registry.members

    def _place_members(self, tree):
        """A candidate member stack on the engine's device: leaves already
        there pass through; a stack from another device (a sampler on a
        spare card) is copied, queued on the current stream.  Under a mesh
        a full (K, ...) candidate is cut to the rank's block (a copy, so
        the full stack is not kept alive); a local one passes through."""
        cut = (self._k_local != self.registry.num_members
               and tree_leaves(tree)[0].shape[0] == self.registry.num_members)
        if cut:
            tree = local_block(tree, self._member_specs, self.mesh)

        def place(a):
            same = a.device.type == self.device.type and (
                self.device.index is None or a.device.index == self.device.index)
            if not same:
                return a.to(self.device, non_blocking=True)
            return a.clone() if cut else a

        return tree_map(place, tree)

    def mark_members_placed(self) -> None:
        """Tell :meth:`_members` the current registry version is already in
        engine placement (the overlapped refresher places candidates through
        :meth:`_place_members` at the flip)."""
        self._placed_version = self.registry.version

    # -- per-tick programs ---------------------------------------------------

    def _member(self, k: int):
        return tree_map(lambda a: a[k], self._members())

    def _generator(self, stream: int, index: int) -> torch.Generator:
        """The engine's generator, reseeded for (stream, index): stream 0 is
        the decode tick, stream 1 the admitted request id."""
        return self._gen.manual_seed(fold_seed(self.seed, stream, index))

    def _note_version(self) -> None:
        """On a promotion, invalidate the paged pool's stale-version prefix
        entries (the sharing key includes the version)."""
        if self.registry.version != self._seen_version:
            self._seen_version = self.registry.version
            if self.paged:
                self.pool.invalidate_version(self.registry.version)

    def _eos_hits(self, tok):
        if self.eos_id is None:
            return torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
        return tok == self.eos_id

    def _mix_select(self, logits, gen):
        """(K, S, V) member logits -> (tokens (S,), mixture logprobs (S, V)),
        fused (one kernel) or unfused — same numerics.  A rank that selects
        a block of the slots takes its rows of the unsharded engine's
        (S, V) Gumbel draw, so its tokens do not depend on the split."""
        gumbel = None
        if self._ax_slot is not None and self.sampling.temperature > 0.0:
            lo, hi = self._slots
            gumbel = gumbel_noise((self.pool.num_slots, logits.shape[-1]), gen,
                                  logits.device)[lo:hi]
        if self._fused_select:
            return fused_mixture_select(logits, gen, mode=self.bma, sampling=self.sampling,
                                        gumbel=gumbel)
        logp = mixture_logprobs(logits, self.bma)
        return select_tokens(logp, gen, self.sampling, gumbel=gumbel), logp

    def _select_tail(self, tok, logp, done, budget):
        """Shared emit/feed/done bookkeeping after token selection."""
        pad = torch.full_like(tok, self.pad_id)
        newly_done = (~done) & (self._eos_hits(tok) | (budget <= 1))
        emit = torch.where(done, pad, tok)
        next_done = done | newly_done
        feed = torch.where(next_done, pad, tok)[:, None]
        return emit, feed, next_done, budget - 1, logp

    def _decode(self, gen):
        """One tick over every slot: dense or paged per-member decode of the
        rank's members and slots, then mixture + selection (the member and
        slot all-gathers under a mesh)."""
        self.trace_counts["decode"] += 1
        K = self._k_local
        lo, hi = self._slots
        rows = []
        if self.paged:
            tables = torch.tensor(self.pool.tables, dtype=torch.int32, device=self.device)
            ctx = torch.tensor(self.pool.ctx, dtype=torch.int32, device=self.device)
            S, M = tables.shape
            j = torch.clamp(ctx.long() // self.pool.block_size, 0, M - 1)
            write_block = torch.where(self._done, 0, tables[torch.arange(S, device=self.device), j])
            for k in range(K):
                logits, _ = self.model.paged.decode_step(
                    self.cfg, self._member(k), self.pool.member(k), self._tokens,
                    tables, ctx, write_block,
                )
                rows.append(logits[:, 0])
        else:
            tokens = self._tokens[lo:hi]
            for k in range(K):
                view = self.pool.member(k)
                logits, new = self.model.decode_step(self.cfg, self._member(k), view, tokens)
                self.pool.caches["t"][k].copy_(new["t"])
                rows.append(logits[:, 0])
        logits = self._gather_members(torch.stack(rows))  # (K, S_local, V)
        tok, logp = self._mix_select(logits, gen)  # (S_local,), (S_local, V)
        return self._gather_slots(*self._select_tail(tok, logp, self._done[lo:hi],
                                                     self._budget[lo:hi]))

    def _admit(self, req: Request, slot: int, table_row=None):
        """Prefill the prompt through every (local) member into ``slot``
        (dense stripe or the table row's pages); returns (first token, slot
        done, mixture logp (V,)), the same on every rank of a mesh."""
        self.trace_counts[f"admit_len{req.prompt.size}"] += 1
        prompt = torch.tensor(req.prompt, dtype=torch.int32, device=self.device)[None]
        rows = []
        for k in range(self._k_local):
            logits, slot_cache = self.model.prefill(
                self.cfg, self._member(k), {"tokens": prompt}, self.max_seq, self.cache_dtype
            )
            if self.paged:
                row = torch.tensor(table_row, dtype=torch.int32, device=self.device)
                self.model.paged.prefill_write(
                    self.cfg, self.pool.member(k), slot_cache, row, self.pool.block_size
                )
            else:
                self.pool.write_slot(k, slot, slot_cache)
            rows.append(logits[0, -1])
        logp = mixture_logprobs(self._gather_members(torch.stack(rows)), self.bma)  # (V,)
        tok = select_tokens(logp, self._generator(1, req.rid), self.sampling)  # 0-d
        slot_done = bool(self._eos_hits(tok)) or req.max_new <= 1
        self._tokens[slot, 0] = self.pad_id if slot_done else tok
        self._done[slot] = slot_done
        self._budget[slot] = req.max_new - 1
        return int(tok), slot_done, logp

    # -- serving loop -------------------------------------------------------

    def _finalize(self, slot, act: _Active, step: int, now: float, results: list):
        r = act.result
        r.tokens = np.asarray(act.tokens, np.int32)
        r.finished_step = step
        r.latency_s = now - act.submit_s
        r.hit_eos = self.eos_id is not None and r.num_tokens > 0 and int(r.tokens[-1]) == self.eos_id
        if self.record_logprobs:
            r.logprobs = np.asarray(act.logprobs, np.float32)
        results.append(r)
        self.pool.release(slot)
        obs_trace.get().instant(
            "serve.retire", cat="serve", rid=r.rid, slot=slot,
            tokens=r.num_tokens, eos=bool(r.hit_eos),
        )

    def _do_admit(self, req: Request, step: int, submit_s: float, active: dict, results: list, wall):
        need = int(req.prompt.size) + req.max_new
        if need > self.max_seq:
            # the non-windowed cache write clamps at max_seq-1, which would
            # silently corrupt the tail — refuse instead
            raise ValueError(
                f"request {req.rid}: prompt_len + max_new = {need} exceeds "
                f"engine max_seq={self.max_seq}"
            )
        slot = self.pool.acquire()
        with obs_trace.get().span(
            "serve.admit", cat="serve", rid=req.rid, slot=slot,
            prompt_len=int(req.prompt.size), step=step,
        ):
            table_row = None
            if self.paged:
                table_row = self.pool.admit_blocks(
                    slot, req.prompt, req.max_new, self.registry.version
                )
            tok, slot_done, logp = self._admit(req, slot, table_row)
        now = wall()
        res = RequestResult(rid=req.rid, prompt_len=int(req.prompt.size), admitted_step=step)
        res.first_token_s = now - submit_s
        act = _Active(result=res, submit_s=submit_s, tokens=[tok])
        if self.record_logprobs:
            act.logprobs.append(logp.cpu().numpy())
        if slot_done:
            self._finalize(slot, act, step, now, results)
        else:
            active[slot] = act

    def run(self, requests, *, max_steps: int | None = None) -> ServeReport:
        """Serve ``requests`` (a list of :class:`Request`) to completion.

        Per scheduler tick: (1) admit pending arrivals into free slots
        (prefill-on-admit, first token emitted), (2) pump the snapshot
        refresher (amortized: a whole sampler chunk lands once per
        ``refresh_every`` ticks, its cost spread over every tick in
        between), (3) one decode step for the whole slot axis, (4) collect
        emissions, finalise and recycle finished slots.  Idle periods
        fast-forward the tick clock.  Hitting ``max_steps`` finalises
        in-flight requests (``truncated=True``); still-pending requests are
        dropped."""
        queue = FCFSQueue(requests)
        active: dict[int, _Active] = {}
        results: list[RequestResult] = []
        submit_s: dict[int, float] = {}
        step = 0
        steps_at_start = self.decode_steps
        t0 = time.perf_counter()
        wall = lambda: time.perf_counter() - t0
        budget_steps = max_steps if max_steps is not None else 1 << 60
        while (len(queue) or active) and step < budget_steps:
            if not active and len(queue) and queue.next_arrival() > step:
                step = queue.next_arrival()  # idle: jump to the next arrival
            for r in queue.visible(step):
                submit_s.setdefault(r.rid, wall())  # schedulable => clock starts
            while self.pool.free_slots:
                req = queue.peek(step)
                if req is None:
                    break
                if not self.pool.can_admit(req.prompt, req.max_new, self.registry.version):
                    # FCFS head-of-line: wait for completions to free pages;
                    # with nothing in flight no pages will ever free
                    if not active and self.pool.active_slots == 0:
                        raise ValueError(
                            f"request {req.rid}: prompt_len + max_new = "
                            f"{int(req.prompt.size) + req.max_new} can never fit the "
                            f"page pool (free={self.pool.alloc.free_blocks} blocks "
                            f"of {self.pool.block_size})"
                        )
                    break
                queue.pop()
                self._do_admit(req, step, submit_s[req.rid], active, results, wall)
            if self.refresher is not None and self.refresh_every:
                # every tick: flip-if-ready + credit-paced micro-chunks
                self.refresher.pump(step)
            self._note_version()  # promotions (any source) invalidate stale prefixes
            if active:
                # the span covers launch AND the emissions fetch below, which
                # waits for the device: the true per-tick wall time
                tick_span = obs_trace.get().span(
                    "serve.decode_tick", cat="serve", step=step, active=len(active),
                )
                tick_span.__enter__()
                if self.paged:
                    # host-side growth first: every live slot must own the
                    # page its fed token writes into
                    for slot in active:
                        self.pool.ensure_decode_block(slot)
                emit, feed, done, budget, logp = self._decode(self._generator(0, step))
                if self.paged:
                    for slot in active:  # fed token consumed position ctx
                        self.pool.advance(slot)
                self._tokens, self._done, self._budget = feed, done, budget
                self.decode_steps += 1
                emit_np = emit.cpu().numpy()
                done_np = done.cpu().numpy()
                logp_np = logp.cpu().numpy() if self.record_logprobs else None
                tick_span.__exit__(None, None, None)
                now = wall()
                for slot, act in list(active.items()):
                    act.tokens.append(int(emit_np[slot]))
                    if self.record_logprobs:
                        act.logprobs.append(logp_np[slot])
                    if done_np[slot]:
                        self._finalize(slot, act, step, now, results)
                        del active[slot]
            step += 1
        if active:  # max_steps truncation: finalise + recycle in-flight slots
            self._done[torch.tensor(sorted(active), dtype=torch.long, device=self.device)] = True
            now = wall()
            for slot, act in list(active.items()):
                act.result.truncated = True
                self._finalize(slot, act, step, now, results)
                del active[slot]
        results.sort(key=lambda r: r.rid)
        report = ServeReport(
            results=results,
            wall_s=wall(),
            decode_steps=self.decode_steps - steps_at_start,
            total_tokens=sum(r.num_tokens for r in results),
            trace_counts=dict(self.trace_counts),
            pool=self.pool.stats(),
            registry=self.registry.stats(),
            refresher=self.refresher.stats() if self.refresher else None,
        )
        self._absorb_metrics(report)
        return report

    def _absorb_metrics(self, report: ServeReport) -> None:
        """Fold the run's stats() dicts + per-request latencies into the
        canonical metrics registry.  Host-side, once per run."""
        reg = obs_metrics.default_registry()
        reg.absorb("serve.engine", {
            "decode_steps": self.decode_steps,
            "total_tokens": report.total_tokens,
            "retired": len(report.results),
            "wall_s": report.wall_s,
            "tokens_per_s": report.tokens_per_s,
        })
        if self.paged:
            alloc = self.pool.alloc.stats()
            reg.absorb("serve.alloc", alloc)
            reg.absorb("serve.pool", {k: v for k, v in report.pool.items() if k not in alloc})
        else:
            reg.absorb("serve.pool", report.pool)
        reg.absorb("serve.registry", report.registry)
        if report.refresher:
            reg.absorb("serve.refresh", report.refresher)
        lat = reg.histogram("serve.request.latency_s")
        ftl = reg.histogram("serve.request.first_token_s")
        for r in report.results:
            lat.observe(r.latency_s)
            ftl.observe(r.first_token_s)
