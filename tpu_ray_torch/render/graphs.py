"""A frame's blocks replayed as CUDA graphs: the port's counterpart of
`jax.jit` over render_image (`tpu_ray/render/render.py:758-760`), with no
counterpart module in the JAX package.

`render_pixels_flat_jit` renders what `render.render_pixels_flat` renders,
through a FramePlan captured once per key: the config, the method, the
block size, the march group's size and the frame's structure (the type
and static fields of the scene, its tables and their every tensor's shape,
dtype and device). A plan owns static copies of those tensors and of a
block's inputs, and three graphs in one memory pool:

  * group: `render.march_group`, the primary march of a group of
    MARCH_GROUP blocks (of every block when the frame has fewer); the last
    group of a frame is padded, with the samples the buffer held before,
    so one graph serves every group (`mixed`: 1013 blocks = 31 x 32 + 21);
  * block: `render.render_block` of one block from its samples and its
    slice of the group's march -> its (3, n_px) colours and its geometry
    residuals (with no group: one block a frame, or no SDF, the block
    marches itself);
  * vjp, at the first backward, one per set of inputs that want a
    gradient: `render.shade_block` of a block from its residuals inside
    autograd, and the product of its colours' Jacobian with the block's
    slice of the image cotangent, added into static gradient buffers.

Every call copies the frame's tensors into the plan's buffers (`load`):
`fit.apply_params`, `cuda_shade.pack` and `mesh_table` make new tensors
each step or frame, and a graph reads the storage it captured. A block
replay is a few copies in (its samples, its march slice), one graph
launch, and one copy out (its colours).

Gradients go through one autograd Function over the frame (_FrameFn). Its
forward replays the block graph and keeps each block's geometry residuals
(~30 bytes a ray); its backward replays the vjp graph block by block, in
reverse, the order in which eager autograd sums the blocks' contributions.
The geometry pass does not run again; the shade forward does (one more
launch of #5 a block, inside `cuda_shade.ShadeFn`).

Launch counts: the kernel wrappers count in Python, which a replay does
not run. A Graph records each LAUNCHES table's change during its capture,
takes it back (nothing ran), and adds it at every replay; the warm-up's
launches ran and stay counted.

Tracing (utils/metrics.py): the group, block and vjp graphs capture the
stage markers of what they run (`march`; `rays` to `shade`;
`vjp.forward`, `vjp.backward`, `vjp.accumulate`), so a replay's device
work is named by stage at no host cost. Host spans: `render.prepare` (the
key and the plan), `render.load`, `render.group` and `render.block` (a
replay with its copies), `render.backward` and `render.vjp` (a vjp replay
with its copies). Always on, by graph kind (`counters()`): replays, the
host ns inside the replays' graph launches, captures, and the seconds of
`prepare` (warm-up and capture). Always on too, by walk kind
(`walk_counters()`): what the mesh walks did (cuda_mt.COUNTERS), the
captured launches' at every replay; and (`scatter_counters()`) what the
vertex gradient's corner scatter did (cuda_scatter.COUNTERS).

On the CPU nothing is captured: the same plan runs each graph's callable
at every replay. On a CUDA device nothing falls back: a warm-up or a
capture that fails (a host sync, an op capture refuses, a kernel the
wrappers reject) raises.

A scene partitioned around a process group's ring (`scene.ring`,
dist/scene_shard.py) renders here too: its shard's tensors are leaves of
the plan and its size, rank and process group static parts of the key
(the group by identity), so the block graph captures the ring's rotation
(`batch_isend_irecv` under NCCL) with the walks. Its warm-up rotates
first, outside the capture, which creates NCCL's point-to-point
communicators. The vjp graph never walks the ring: the shade reads the
replicated mesh. The sharded frame's gather (dist/sharding.py) and the
sharded fit step's gradient all-reduce (dist/grad_allreduce.py) are Graphs
of their own, in PLANS under keys that name their group. Such a graph must
not outlive its group: `drop_plans` (through `dist.multihost.destroy`)
drops them before the group is destroyed. Captures run in the
"thread_local" mode, so that ProcessGroupNCCL's watchdog thread may query
its events while this thread captures.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import types

import torch
from torch.autograd.function import once_differentiable

from tpu_ray_torch.dist.multihost import live_group
from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct, cuda_scatter, cuda_sdf, cuda_shade
from tpu_ray_torch.kernels.build import kernel_lib
from tpu_ray_torch.render import render
from tpu_ray_torch.utils.metrics import span, stage

LAUNCH_TABLES = (cuda_sdf.LAUNCHES, cuda_mt.LAUNCHES, cuda_shade.LAUNCHES,
                 cuda_reconstruct.LAUNCHES, cuda_scatter.LAUNCHES)


def _snapshot() -> list:
    return [dict(t) for t in LAUNCH_TABLES]


def _add_counts(deltas: list, sign: int) -> None:
    for table, delta in zip(LAUNCH_TABLES, deltas):
        for k, n in delta.items():
            table[k] += sign * n


# what every Graph of a kind did in this process, updated in place
_COUNTS = {}
COUNT_KEYS = ("replays", "launch_ns", "captures", "prepare_s")


def counters() -> types.MappingProxyType:
    """A read-only snapshot of the graphs' counts in this process, by kind
    ("group", "block", "vjp", and dist/'s "gather" and "allreduce"): the
    replays (on the CPU too, where the callable runs), the host ns spent
    inside the CUDA graph launches of those replays (a launch waits there
    while the device's launch queue is full), the captures, and the
    seconds inside `prepare` that warmed up and captured (the kernel
    library is built and loaded before the clock starts)."""
    return types.MappingProxyType({k: types.MappingProxyType(dict(v))
                                   for k, v in _COUNTS.items()})


# the mesh walks' counters, read beside counters(): by kind ("closest" and
# "any_hit" for #3, "resident_closest" and "resident_any_hit" for #4), the
# chunks staged, MT tests, box passes and slots, supers visited, blocks and
# rays of every launch on a CUDA device, eager or replayed
walk_counters = cuda_mt.walk_counters
# the vertex gradient's scatter's counters, read beside them: launches, rows
# in, rows with a nonzero cotangent, segments (distinct triangles) and the
# longest segment's rows of every scatter on a CUDA device, eager or replayed
scatter_counters = cuda_scatter.scatter_counters


class Graph:
    """A callable captured once and replayed: on a CUDA device, after one
    warm-up run on a side stream (the kernel library built and loaded
    first), a torch.cuda.CUDAGraph in the plan's pool, at its first
    replay; on the CPU the callable itself, run at every replay. `out`:
    what the callable returned (on a CUDA device, the graph's static
    outputs, rewritten by each replay). `deltas`: each LAUNCHES table's
    change during the capture, added at every replay. kind: the name its
    counts go under (counters())."""

    def __init__(self, fn, device: torch.device, pool, kind: str):
        self.fn, self.device, self.pool = fn, device, pool
        self.graph = None
        self.out = None
        self.deltas = None
        self.counts = _COUNTS.setdefault(kind, dict.fromkeys(COUNT_KEYS, 0))

    @property
    def captures(self) -> bool:
        return self.device.type == "cuda"

    def prepare(self) -> None:
        """Warm up and capture, on a CUDA device, unless done: the
        callable runs once (the warm-up) on what the buffers hold."""
        if not self.captures or self.graph is not None:
            return
        if torch.cuda.is_available():  # the library built and loaded outside prepare_s
            kernel_lib()
        t0 = time.perf_counter()
        self._warm_up()
        before = _snapshot()
        self.graph, self.out = self._capture()
        self.deltas = [{k: n - b[k] for k, n in t.items() if n != b[k]}
                       for t, b in zip(LAUNCH_TABLES, before)]
        _add_counts(self.deltas, -1)
        self.counts["captures"] += 1
        self.counts["prepare_s"] += time.perf_counter() - t0

    def replay(self):
        self.counts["replays"] += 1
        if not self.captures:
            self.out = self.fn()
            return self.out
        self.prepare()
        t0 = time.perf_counter_ns()
        self._launch()
        self.counts["launch_ns"] += time.perf_counter_ns() - t0
        _add_counts(self.deltas, 1)
        return self.out

    def _warm_up(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            out = self.fn()
        return graph, out

    def _launch(self) -> None:
        self.graph.replay()

    def reset(self) -> None:
        """Free the captured graph (a later replay captures anew)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = self.deltas = None


# ---------------------------------------------------------------------------
# The frame's structure: its tensors, and the rest as the plan's key
# ---------------------------------------------------------------------------

def flatten(obj, leaves: list):
    """obj's tensors appended to leaves, in order -> its structure (hashable):
    dataclasses by field, lists and tuples by item, anything else a static
    value of the key."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("T",)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ("D", type(obj), tuple((f.name, flatten(getattr(obj, f.name), leaves))
                                      for f in dataclasses.fields(obj)))
    if isinstance(obj, (list, tuple)):
        return ("L", type(obj), tuple(flatten(v, leaves) for v in obj))
    hash(obj)  # a static value keys the plan
    return ("S", obj)


def unflatten(node, leaves):
    """flatten's inverse over an iterator of tensors."""
    kind = node[0]
    if kind == "T":
        return next(leaves)
    if kind == "S":
        return node[1]
    if kind == "D":
        return node[1](**{name: unflatten(n, leaves) for name, n in node[2]})
    items = [unflatten(n, leaves) for n in node[2]]
    return items if node[1] is list else node[1](items)


# the plans by key (render_pixels_flat_jit's, and the gather's and the
# all-reduce's of dist/); each holds its graphs' pool and its buffers, ~0.12
# GiB for `mixed` at 1920x1080x16 on an H100
PLANS = {}


def _names(key, match) -> bool:
    """Whether a plan's key holds a value `match` accepts, at any depth."""
    if isinstance(key, tuple):
        return any(_names(k, match) for k in key)
    return match(key)


def drop_plans(group=None) -> int:
    """Drop the plans whose key names the process group (None: any group),
    freeing their graphs, after the device has finished what they launched
    -> how many. Call it before the group is destroyed: a graph that
    captured a communicator's work must not be replayed after it."""
    pg_type = torch.distributed.ProcessGroup if torch.distributed.is_available() else ()
    match = (lambda v: isinstance(v, pg_type)) if group is None else (lambda v: v is group)
    gone = [k for k in PLANS if _names(k, match)]
    if gone and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for k in gone:
        PLANS.pop(k).reset()
    # a plan and its graphs' callables (its bound methods) form a cycle: free
    # them, and their references to the group, before the group is destroyed
    gc.collect()
    return len(gone)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def _buffer(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


@dataclasses.dataclass
class _Vjp:
    """A vjp graph and its buffers: the residuals and the cotangent it reads,
    the gradients it adds into (None where the input wants none), and which
    inputs' gradients the block reaches (the rest stay None, as in eager
    autograd)."""
    graph: Graph
    res: dict
    ct: torch.Tensor
    grads: list
    used: list


class FramePlan:
    """The captured form of render_pixels_flat for one key (see the module
    docstring). leaves / treedef: the frame's tensors and structure, as
    flatten gives them for (scene, mesh_rows, packed); bs: the block size in
    samples; group: blocks a march group (0: no group graph)."""

    def __init__(self, cfg, method: str, treedef, leaves, bs: int, group: int,
                 sample: torch.Tensor):
        self.cfg, self.method, self.treedef, self.bs, self.group = cfg, method, treedef, bs, group
        self.device = sample.device
        self.inputs = [_buffer(x) for x in leaves]
        self.frame = unflatten(treedef, iter(self.inputs))  # (scene, mesh_rows, packed)
        self.pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.x, self.y = _buffer(sample[:bs]), _buffer(sample[:bs])
        self.gx = self.gy = self.march = None
        if group:
            n = group * bs
            self.gx = torch.zeros(n, dtype=sample.dtype, device=self.device)
            self.gy = torch.zeros_like(self.gx)
            self.group_graph = Graph(self._march_group, self.device, self.pool, "group")
        self.block_graph = Graph(self._block, self.device, self.pool, "block")
        self.vjps = {}

    def _march_group(self):
        scene, _, packed = self.frame
        return render.march_group(scene, self.cfg, self.gx, self.gy, packed, self.bs)

    def _block(self):
        scene, mesh_rows, packed = self.frame
        with torch.no_grad():
            colors, res = render.render_block(scene, self.cfg, self.method, self.x, self.y,
                                              mesh_rows, packed, self.march)
        # the geometry pass's hit state serves only the forward shade
        return colors, {k: v for k, v in res.items() if k != "hits"}

    def reset(self) -> None:
        """Free every graph of the plan."""
        graphs = [self.block_graph] + [v.graph for v in self.vjps.values()]
        for g in graphs + ([self.group_graph] if self.group else []):
            g.reset()

    def load(self, leaves) -> None:
        """Copy the frame's tensors into the plan's buffers."""
        with span("render.load"), torch.no_grad():
            for buf, x in zip(self.inputs, leaves):
                buf.copy_(x)

    def _replay_group(self, xs, ys, g: int):
        """The group graph over the samples from g -> its march results."""
        m = min(self.gx.shape[0], xs.shape[0] - g)
        self.gx[:m].copy_(xs[g:g + m])
        self.gy[:m].copy_(ys[g:g + m])
        marched = self.group_graph.replay()
        if self.march is None:
            self.march = tuple(_buffer(v[:self.bs]) for v in marched)
        return marched

    @torch.no_grad()
    def forward(self, xs, ys, keep: bool = False):
        """Replay the frame over samples xs, ys (whole blocks) -> ((3, n_px)
        colours, each residual stacked over the blocks when keep, else
        None)."""
        n, bs, npx = xs.shape[0], self.bs, self.bs // self.cfg.spp
        out = torch.empty((3, n // bs * npx), dtype=xs.dtype, device=xs.device)
        store = None
        step = self.group * bs if self.group else bs
        for g in range(0, n, step):
            marched = None
            if self.group:
                with span("render.group"):
                    marched = self._replay_group(xs, ys, g)
            for s in range(g, min(g + step, n), bs):
                with span("render.block"):
                    self.x.copy_(xs[s:s + bs])
                    self.y.copy_(ys[s:s + bs])
                    if marched is not None:
                        for buf, v in zip(self.march, marched):
                            buf.copy_(v[s - g:s - g + bs])
                    colors, res = self.block_graph.replay()
                    b = s // bs
                    out[:, b * npx:(b + 1) * npx].copy_(colors)
                    if keep:
                        if store is None:
                            store = {k: v.new_empty((n // bs, *v.shape))
                                     for k, v in res.items()}
                        for k, v in res.items():
                            store[k][b].copy_(v)
        return out, store

    def _vjp(self, need: tuple, store: dict) -> _Vjp:
        """The vjp graph for the inputs `need` marks, with its buffers."""
        wanted = [i for i, w in enumerate(need) if w]
        leaves = list(self.inputs)
        for i in wanted:  # aliases of the buffers that take a gradient
            leaves[i] = self.inputs[i].detach().requires_grad_(True)
        scene, mesh_rows, packed = unflatten(self.treedef, iter(leaves))
        res = {k: _buffer(v[0]) for k, v in store.items()}
        ct = torch.empty((3, self.bs // self.cfg.spp), dtype=self.x.dtype, device=self.device)
        grads = [torch.zeros_like(self.inputs[i]) if w else None
                 for i, w in enumerate(need)]
        used = [False] * len(need)

        def vjp():
            dev = self.device
            with torch.enable_grad():
                with stage("vjp.forward", dev):
                    colors = render.shade_block(scene, self.cfg, self.method, self.x, self.y,
                                                res, mesh_rows, packed)
                with stage("vjp.backward", dev):
                    got = torch.autograd.grad(colors, [leaves[i] for i in wanted], ct,
                                              allow_unused=True)
            with stage("vjp.accumulate", dev):
                for i, g in zip(wanted, got):
                    if g is not None:
                        used[i] = True
                        grads[i].add_(g)

        return _Vjp(Graph(vjp, self.device, self.pool, "vjp"), res, ct, grads, used)

    def backward(self, xs, ys, store: dict, ct, need: tuple) -> list:
        """The gradients of <colours, ct> for the inputs `need` marks (None
        for the others and where no block reaches the input): the vjp graph
        replayed over the blocks in reverse."""
        vjp = self.vjps.get(need)
        if vjp is None:
            vjp = self.vjps[need] = self._vjp(need, store)
        npx = self.bs // self.cfg.spp
        with torch.no_grad():
            for i, b in enumerate(reversed(range(xs.shape[0] // self.bs))):
                with span("render.vjp"):
                    s = b * self.bs
                    self.x.copy_(xs[s:s + self.bs])
                    self.y.copy_(ys[s:s + self.bs])
                    for k, buf in vjp.res.items():
                        buf.copy_(store[k][b])
                    vjp.ct.copy_(ct[:, b * npx:(b + 1) * npx])
                    if i == 0:  # the warm-up adds into the gradients: zeroed after it
                        vjp.graph.prepare()
                        for g in vjp.grads:
                            if g is not None:
                                g.zero_()
                    vjp.graph.replay()
        return [g.clone() if g is not None and u else None
                for g, u in zip(vjp.grads, vjp.used)]


class _FrameFn(torch.autograd.Function):
    """colours = _FrameFn.apply(plan, xs, ys, *frame tensors): the plan's
    forward, and its backward by the vjp graph."""

    @staticmethod
    def forward(ctx, plan: FramePlan, xs, ys, *leaves):
        plan.load(leaves)
        out, ctx.store = plan.forward(xs, ys, keep=True)
        ctx.plan = plan
        ctx.save_for_backward(xs, ys, *leaves)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        with span("render.backward"):
            xs, ys, *leaves = ctx.saved_tensors
            ctx.plan.load(leaves)
            grads = ctx.plan.backward(xs, ys, ctx.store, ct, tuple(ctx.needs_input_grad[3:]))
            return (None, None, None, *grads)


def render_pixels_flat_jit(scene, cfg, flat_x, flat_y) -> torch.Tensor:
    """render.render_pixels_flat through the FramePlan of its key (captured
    at the first call of that key) -> (3, n_px). Differentiable with
    respect to every tensor of the scene, as render_pixels_flat is. A ring
    scene's plan keys on the ring's process group itself (the default
    group for None). Its key and plan lookup are the span `render.prepare`."""
    with span("render.prepare"):
        method = render.resolve_method(scene, cfg)
        scene = scene.replace(grid=None)  # the DDA oracle's, never read by a frame
        if scene.ring is not None:
            scene = scene.replace(ring=dataclasses.replace(scene.ring,
                                                           group=live_group(scene.ring.group)))
        leaves = []
        treedef = flatten((scene, *render.frame_tables(scene, cfg, method)), leaves)
        n_px = flat_x.shape[0] // cfg.spp
        xs, ys, bs = render.whole_blocks(cfg, flat_x, flat_y)
        n_blocks = xs.shape[0] // bs
        group = (min(render.MARCH_GROUP, n_blocks)
                 if render._use_sdf(scene, method) and n_blocks > 1 else 0)
        key = (cfg, method, bs, group, treedef, xs.dtype, xs.device,
               tuple((tuple(x.shape), x.dtype, x.device) for x in leaves))
        plan = PLANS.get(key)
        if plan is None:
            plan = PLANS[key] = FramePlan(cfg, method, treedef, leaves, bs, group, xs)
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        out = _FrameFn.apply(plan, xs, ys, *leaves)
    else:
        plan.load(leaves)
        out = plan.forward(xs, ys)[0]
    return out[:, :n_px]
