"""One run of a cell: the trainer users run, built from the cell's files
and the seed, its first steps checked against the reference, then a timed
window of `Trainer.train`.

Set-up builds one `Trainer` (cpc_tpu_torch/train/trainer.py) over a corpus
made from the seed (uploaded to the card when the traffic's feed is
"device", else read by the Batcher's thread from host memory), loads the seed's weights into it, and drives it
through its first CHECKED_STEPS steps by `Trainer.train` itself; a tap on
`train_step` keeps their losses and inputs, the Adam state after the first
gives the first gradient, and the parameters after the last their change.
The same trainer then trains through the window, which a timer ends
through the trainer's own preemption flag (under a mesh the ranks agree on
it by `any_true`, as on a real preemption). The clock reads a synced
device at both ends: a rate is all the audio of the window's steps over
all of its time.

With a trace, the window's steps TRACE_START .. TRACE_START + n run under
`torch.profiler` (the card's activity), with host spans around the
Batcher's next batch (feed), the trainer's staging of it on the card
(stage), the `train_step` call (step) and `multihost.any_true` (agree);
nothing of the program is edited.

After the window the peak memory is read, the program is freed, and rank
0 runs the reference (`reference.train_steps`) on the same weights and the
same global rows; `check` compares the two.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from h100_bench import check, inputs, reference, spec
from h100_bench.dims import dims as cell_dims
from h100_bench.trace import Tracer

CHECKED_STEPS = 3
TRACE_START = 20  # window steps before the trace starts
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cpc_tpu")
NEVER = 1 << 40   # a step count no window reaches


def forbidden_modules(names=None) -> List[str]:
    """Top-level module names (before the first dot, compared whole) of
    `names` (default: sys.modules) that a run may not load."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def program_config(cell: spec.Cell, seed: int):
    """(CPCConfig, its dict): the configuration file's settings with the
    traffic's batch, snippet length and feed, seeded by `seed`."""
    from cpc_tpu_torch.config import from_dict

    d = copy.deepcopy(cell.config["config"])
    t = cell.traffic
    d["data"].update(batch_size=t["batch_size"],
                     snippet_samples=t["snippet_samples"],
                     device_corpus=t["feed"] == "device")
    d["train"]["seed"] = int(seed)
    return from_dict(d), d


class StepTap:
    """Stands in for `train_step`: keeps the first `keep` steps' metrics
    and last argument (the batch, or the index vector of a device corpus),
    and with a tracer marks and spans each step."""

    def __init__(self, fn, keep: int):
        self.fn, self.keep = fn, keep
        self.kept: list = []
        self.tracer: Optional[Tracer] = None
        self.calls = 0

    def __call__(self, *args, **kw):
        tr = self.tracer
        if tr is None:
            out = self.fn(*args, **kw)
        else:
            tr.before(self.calls)
            with tr.span("step"):
                out = self.fn(*args, **kw)
        if len(self.kept) < self.keep:
            self.kept.append((args[-1].detach().clone(), out["loss"],
                              out["acc_mean"]))
        self.calls += 1
        if tr is not None:
            tr.after(self.calls - 1)
        return out


class SpannedBatcher:
    """The trainer's Batcher, with a span around each next batch while the
    tracer runs."""

    def __init__(self, inner, tracer: Tracer):
        self.inner, self.tracer = inner, tracer

    def __iter__(self):
        it = iter(self.inner)
        try:
            while True:
                with self.tracer.span("feed"):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item
        finally:
            it.close()

    def __getattr__(self, name):
        return getattr(self.inner, name)


@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    dims: dict
    setup_s: float
    window_s: float
    steps: int
    audio_per_step: float      # seconds of audio a step, global batch
    peak: Optional[dict]       # the card's published peaks
    parts: dict                # part -> counting module
    trace: object = None       # rank 0's TraceSummary


def make_mesh(rank: int, world: int, port: Optional[int], device="cuda"):
    """This process's mesh of `world` ranks (NCCL on cards, gloo on the
    CPU), or None for one."""
    if world == 1:
        return None
    from cpc_tpu_torch.parallel import multihost
    kind = "cuda" if torch.device(device).type == "cuda" else "cpu"
    return multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                device=kind, timeout=300)


def leave(mesh) -> None:
    if mesh is not None:
        from cpc_tpu_torch.parallel import multihost
        multihost.shutdown()


class Session:
    """One process's share of a run of one seed: rank `mesh.rank` of the
    mesh's ranks, or the only one."""

    def __init__(self, cell: spec.Cell, seed: int, *, device="cuda",
                 mesh=None):
        self.cell, self.seed = cell, int(seed)
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        self.world = 1 if mesh is None else mesh.size
        self.device = torch.device(device) if mesh is None else mesh.device
        self.cfg, self.cfg_dict = program_config(cell, seed)
        self.dims = cell_dims(cell.config, cell.traffic)

    # ------------------------------------------------------------ set-up
    def build(self) -> None:
        """The corpus, the trainer and the seed's weights in it."""
        from cpc_tpu_torch.train.trainer import Trainer

        t = self.cell.traffic
        self.corpus = inputs.make_corpus(t["corpus_snippets"],
                                         t["snippet_samples"], self.seed,
                                         self.device).cpu().numpy()
        dataset = inputs.ArrayDataset(self.corpus)
        self.trainer = Trainer(self.cfg, dataset, device=self.device,
                               mesh=self.mesh)
        specs = reference.param_specs(self.cfg_dict["model"])
        self.weights = inputs.make_weights(specs, self.seed, self.device)
        params = dict(self.trainer.model.named_parameters())
        if set(params) != set(self.weights):
            raise RuntimeError(
                f"the program's parameters are not the reference's: "
                f"{sorted(set(params) ^ set(self.weights))}")
        with torch.no_grad():
            for k, p in params.items():
                if tuple(p.shape) != tuple(self.weights[k].shape):
                    raise RuntimeError(
                        f"{k}: the program's {tuple(p.shape)} is not "
                        f"{tuple(self.weights[k].shape)}")
                p.copy_(self.weights[k])
        if self.mesh is not None:
            from cpc_tpu_torch.parallel import multihost
            multihost.replicate(list(params.values()), self.mesh)
        self.steps_fns = self.trainer.steps
        self.tap = StepTap(self.steps_fns.train_step, CHECKED_STEPS)
        self.trainer.steps = self.steps_fns._replace(train_step=self.tap)

    def first_steps(self) -> dict:
        """Drives the trainer through its checked steps; the program's
        readings (rank 0's state, which every rank holds alike)."""
        tr = self.trainer
        opt = self.steps_fns.optimizer
        tr.train(1)
        g = torch.stack([m.norm() for m in opt.mu.values()]) / (1.0 - opt.b1)
        tr.train(CHECKED_STEPS)
        params = dict(tr.model.named_parameters())
        ch = torch.stack([(p.detach() - self.weights[k]).norm()
                          for k, p in params.items()])
        names = list(params)
        kept = self.tap.kept
        return {"loss": [float(x[1]) for x in kept],
                "acc": [float(x[2]) for x in kept],
                "grad_norm": dict(zip(list(opt.mu), g.cpu().tolist())),
                "change_norm": dict(zip(names, ch.cpu().tolist())),
                "inputs": [x[0].cpu().numpy() for x in kept]}

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tracer: Optional[Tracer] = None):
        """(steps, seconds, start on the host clock, the trainer's last
        metrics) of a window of `seconds` (rank 0's timer); with `tracer`
        its steps are traced."""
        tr = self.trainer
        restore = []
        if tracer is None:
            tr.steps = self.steps_fns
        else:
            self.tap.tracer, self.tap.calls = tracer, 0
            inner = tr.batcher
            tr.batcher = SpannedBatcher(inner, tracer)
            restore.append(lambda: setattr(tr, "batcher", inner))
            stage = tr._stage

            def staged(host_batch):
                with tracer.span("stage"):
                    return stage(host_batch)
            tr._stage = staged
            restore.append(lambda: delattr(tr, "_stage"))
            if self.mesh is not None:
                from cpc_tpu_torch.parallel import multihost
                agree = multihost.any_true

                def spanned(flag, mesh):
                    with tracer.span("agree"):
                        return agree(flag, mesh)
                multihost.any_true = spanned
                restore.append(lambda: setattr(multihost, "any_true", agree))
        timer = None
        if self.rank == 0:
            timer = threading.Timer(seconds,
                                    lambda: setattr(tr, "preempted", True))
        self._sync()
        t0 = time.perf_counter()
        s0 = tr.step
        if timer is not None:
            timer.start()
        try:
            last = tr.train(tr.step + NEVER)
        finally:
            if timer is not None:
                timer.cancel()
            if tracer is not None:
                tracer.finish()
            for undo in restore:
                undo()
        self._sync()
        return tr.step - s0, time.perf_counter() - t0, t0, last

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ after
    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def gather(self, obj) -> list:
        """Every rank's `obj`, in rank order (the host group)."""
        if self.mesh is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.mesh.host_group)
        return out

    def free(self) -> None:
        """Closes the trainer and frees the card."""
        self.trainer.close()
        del self.trainer, self.tap, self.steps_fns
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, local_inputs: List[list],
                  precision: str = "fp32") -> dict:
        """The reference's readings on the same weights and the global
        rows of the checked steps (every rank's share, in rank order)."""
        batches = []
        for step in range(CHECKED_STEPS):
            parts = [r[step] for r in local_inputs]
            rows = np.concatenate(parts)
            if rows.ndim == 1:  # a device corpus's indices
                rows = self.corpus[rows]
            batches.append(torch.from_numpy(np.ascontiguousarray(rows))
                           .to(self.device))
        return reference.train_steps(self.weights, batches, self.cfg_dict,
                                     precision)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", rank: int = 0, world: int = 1,
        port: Optional[int] = None) -> Optional[dict]:
    """One run; rank 0 returns the result line's object, other ranks
    None."""
    mesh = make_mesh(rank, world, port, device)
    s = Session(cell, seed, device=device, mesh=mesh)
    try:
        s.build()
        prog = s.first_steps()
        tracer = None
        if trace:
            tracer = Tracer(TRACE_START, cell.traffic["trace_steps"],
                            spec.stages())
            tracer.warm(s.device)
        steps, window_s, t0, last = s.window(seconds, tracer)
        setup_s = t0 - t_start
        mine = {"peak": s.memory_peak(), "inputs": prog.pop("inputs"),
                "trace": tracer.summary if tracer else None}
        every = s.gather(mine)
        s.free()
    finally:
        leave(mesh)
    if rank != 0:
        return None
    t_ref = time.perf_counter()
    ref = s.reference([m["inputs"] for m in every])
    print(f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    nums = check.numbers(prog, ref)
    ok, checks = check.verdict(nums, cell.limits)
    t = cell.traffic
    rec = Record(dims=s.dims, setup_s=setup_s, window_s=window_s,
                 steps=steps,
                 audio_per_step=t["batch_size"] * t["snippet_samples"]
                 / s.cfg.data.sample_rate,
                 peak=_peaks(s.device), parts=spec.count_modules(),
                 trace=mine["trace"])
    wanted = cell.per_layer if trace else cell.end_to_end
    readers = spec.readers([m["name"] for m in wanted])
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if s.device.type == "cuda" else s.device.type,
           "kind": (torch.cuda.get_device_name(s.device)
                    if s.device.type == "cuda" else "cpu"),
           "count": world,
           "memory_peak_bytes": max(m["peak"] for m in every)}
    finite = all(bool(torch.isfinite(torch.as_tensor(v)).all())
                 for v in last.values())
    out = {"correct": ok, "attempted": steps, "failed": int(not finite),
           "metrics": metrics, "device": dev}
    if trace and tracer.summary is not None:
        summaries = [m["trace"] for m in every if m["trace"] is not None]
        dev["busy_s"] = sum(x.busy_s for x in summaries) / len(summaries)
        dev["window_s"] = sum(x.window_s for x in summaries) / len(summaries)
        out["breakdown"] = breakdown(tracer.summary)
        for name, stage, sec in tracer.summary.top_ops:
            print(f"trace op {sec / tracer.summary.steps * 1e3:.4f} ms a "
                  f"step [{stage}] {name[:160]}", file=sys.stderr)
    check.report(nums, checks)
    out["checks"] = checks
    return out


def breakdown(tr) -> dict:
    ops = sorted(tr.stage_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = [[f"{name}: {n} gaps, longest {longest * 1e3:.4f} ms", total]
            for name, n, total, longest in tr.gaps[:10]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def _peaks(device) -> Optional[dict]:
    if device.type != "cuda":
        return None
    return spec.peaks(torch.cuda.get_device_name(device))


def spawn_ranks(module: str, argv: List[str], world: int,
                port: int) -> list:
    """Starts ranks 1 .. world-1 as `python -m module argv --rank r --port
    port`, their standard output sent to standard error."""
    return [subprocess.Popen([sys.executable, "-m", module, *argv,
                              "--rank", str(r), "--port", str(port)],
                             stdout=sys.stderr, stderr=sys.stderr)
            for r in range(1, world)]


def reap(procs: list, timeout: float) -> List[int]:
    """Waits for every process (killing those still running after
    `timeout` seconds); their exit codes."""
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def checkout_caches(root) -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(str(root), "build", sub)
