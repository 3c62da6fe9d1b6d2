"""Training supervisor: restarts a crashed or hung training process.

Port of `cpc_tpu/train/supervisor.py`. Exact resume (`train.checkpoint`,
`Trainer.maybe_resume`) makes a restart safe; this module decides when one
is needed and starts it. Two failures:

  * crash: the child dies (host OOM kill, device error, a bug), seen as a
    nonzero exit;
  * hang: the child blocks for good (a wedged device or collective) and no
    exit code ever arrives; only a stale heartbeat shows it.

The child is the training CLI, `python -m cpc_tpu_torch.train`, run with
the supervisor's own flags taken out; a restart appends `--resume`. The
heartbeat is the workdir: `metrics.jsonl` is line-buffered and the
checkpoints arrive every `checkpoint_every` steps as
`checkpoints/step_<n>.pt` (the port's layout, not orbax's digit-named
directories), so detection needs nothing from the child.

The restart budget, `max_restarts`, counts consecutive restarts without a
new checkpoint: any progress resets it, so only a crash loop (a corrupt
corpus failing at step 0) spends it. A stale child gets SIGTERM first (the
Trainer saves a checkpoint at the step it is on and returns) and SIGKILL
after `term_grace` seconds; resume then replays at most `checkpoint_every`
steps.

CLI: `python -m cpc_tpu_torch.train --supervise [--stale-after S]
[--max-restarts N] ...`.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

from cpc_tpu_torch.train.checkpoint import CheckpointManager

DEFAULT_STALE_AFTER = 1200.0  # seconds; > the longest quiet period observed
DEFAULT_MAX_RESTARTS = 5
_BACKOFF_CAP = 300.0

# flags consumed by the supervisor itself, never forwarded to the child
_SUPERVISOR_FLAGS = ("--supervise", "--stale-after", "--max-restarts")
_FLAGS_WITH_VALUE = ("--stale-after", "--max-restarts")


@dataclasses.dataclass
class SupervisedRun:
    exit_code: int
    restarts: int
    events: List[str]


def strip_supervisor_flags(argv: Sequence[str]) -> List[str]:
    """The child command is the supervisor's command minus its own flags
    (both ``--flag value`` and ``--flag=value`` spellings)."""
    out: List[str] = []
    it = iter(argv)
    for tok in it:
        name = tok.split("=", 1)[0]
        if name in _SUPERVISOR_FLAGS:
            if name in _FLAGS_WITH_VALUE and "=" not in tok:
                next(it, None)  # swallow the detached value token
            continue
        out.append(tok)
    return out


def latest_checkpoint_step(workdir: str) -> int:
    """Newest checkpoint step in the workdir, or -1. A checkpoint file is
    written to a temporary name and renamed, so a `step_<n>.pt` is
    complete."""
    steps = CheckpointManager(os.path.join(workdir, "checkpoints")).steps()
    return steps[-1] if steps else -1


def _heartbeat_mtime(workdir: str) -> float:
    """Newest progress timestamp the child has left in the workdir."""
    newest = 0.0
    for p in (os.path.join(workdir, "metrics.jsonl"),
              os.path.join(workdir, "checkpoints")):
        try:
            newest = max(newest, os.stat(p).st_mtime)
        except OSError:
            pass
    ckpt = os.path.join(workdir, "checkpoints")
    try:
        for d in os.listdir(ckpt):
            newest = max(newest, os.stat(os.path.join(ckpt, d)).st_mtime)
    except OSError:
        pass
    return newest


def _terminate(proc: subprocess.Popen, term_grace: float,
               log: Callable[[str], None]) -> None:
    if proc.poll() is not None:
        return
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=term_grace)
        log(f"child {proc.pid} exited {proc.returncode} after SIGTERM")
    except subprocess.TimeoutExpired:
        proc.kill()  # wedged (blocked in C): escalate
        proc.wait()
        log(f"child {proc.pid} ignored SIGTERM for {term_grace:.0f}s; "
            "SIGKILLed")


def supervise(child_argv: Sequence[str], workdir: str, *,
              stale_after: float = DEFAULT_STALE_AFTER,
              max_restarts: int = DEFAULT_MAX_RESTARTS,
              poll: float = 10.0,
              term_grace: float = 60.0,
              backoff: float = 10.0,
              log: Optional[Callable[[str], None]] = None) -> SupervisedRun:
    """Run ``child_argv`` under crash/hang supervision until it exits 0 or
    the no-progress restart budget is spent. Restarts append ``--resume``.

    Events are echoed via ``log`` (default: stamped lines to stderr) and
    appended to ``<workdir>/supervisor.log``; the live child pid is kept in
    ``<workdir>/supervisor_child.pid`` for operators (and tests) that need
    to target the right process.
    """
    os.makedirs(workdir, exist_ok=True)
    events: List[str] = []
    ev_path = os.path.join(workdir, "supervisor.log")
    pid_path = os.path.join(workdir, "supervisor_child.pid")

    def _log(msg: str) -> None:
        stamped = f"[supervisor {time.strftime('%H:%M:%S')}] {msg}"
        events.append(msg)
        with open(ev_path, "a") as f:
            f.write(stamped + "\n")
        if log is not None:
            log(msg)
        else:
            print(stamped, file=sys.stderr, flush=True)

    base = list(child_argv)
    consecutive = 0
    restarts = 0
    exit_code = 1
    while True:
        argv = base if restarts == 0 else (
            base if "--resume" in base else base + ["--resume"])
        step_at_spawn = latest_checkpoint_step(workdir)
        spawned = time.time()
        proc = subprocess.Popen(argv)
        with open(pid_path, "w") as f:
            f.write(str(proc.pid))
        _log(f"spawned pid {proc.pid} (attempt {restarts + 1}, "
             f"checkpoint step {step_at_spawn}): {' '.join(argv)}")

        failure = None  # set to a reason string when this attempt failed
        while True:
            rc = proc.poll()
            if rc is not None:
                if rc == 0:
                    _log("child exited 0 — done")
                    return SupervisedRun(0, restarts, events)
                failure = f"exit code {rc}"
                break
            age = time.time() - max(_heartbeat_mtime(workdir), spawned)
            if age > stale_after:
                failure = (f"no progress for {age:.0f}s "
                           f"(stale_after={stale_after:.0f}s)")
                _log(f"STALE: {failure} — terminating pid {proc.pid}")
                _terminate(proc, term_grace, _log)
                break
            time.sleep(poll)

        rc = proc.returncode
        # signal deaths are negative; report the shell convention 128+sig so
        # callers see a meaningful positive status, not a wrapped arbitrary
        # byte (SystemExit(-9) would exit 247)
        exit_code = (128 - rc) if rc and rc < 0 else (rc or 1)
        progressed = latest_checkpoint_step(workdir) > step_at_spawn
        consecutive = 0 if progressed else consecutive + 1
        _log(f"attempt failed ({failure}); progressed={progressed} "
             f"consecutive_no_progress={consecutive}")
        if consecutive > max_restarts:
            _log(f"restart budget spent ({max_restarts} consecutive "
                 "no-progress restarts) — giving up")
            return SupervisedRun(exit_code, restarts, events)
        restarts += 1
        delay = min(backoff * (2 ** max(consecutive - 1, 0)), _BACKOFF_CAP)
        _log(f"restarting with --resume in {delay:.0f}s")
        time.sleep(delay)


def supervise_cli(args, argv: Optional[Sequence[str]]) -> int:
    """The training CLI's --supervise: runs the same command, without the
    supervisor's flags, as the supervised child."""
    if args.distributed or args.coordinator is not None:
        # each process restarting independently would desync the collective;
        # multi-process jobs need a cluster-level restart policy instead
        raise SystemExit("--supervise does not compose with --distributed "
                         "(restart the whole job, not one process)")
    raw = list(sys.argv[1:] if argv is None else argv)
    child = [sys.executable, "-m", "cpc_tpu_torch.train"] + \
        strip_supervisor_flags(raw)
    res = supervise(child, args.workdir, stale_after=args.stale_after,
                    max_restarts=args.max_restarts)
    return res.exit_code
