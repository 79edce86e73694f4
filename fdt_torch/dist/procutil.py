"""Multi-process worker jobs (counterpart of fdt/dist/procutil.py).

A job of several ranks is a set of worker processes; each must run under

  (a) ONE shared wall-clock deadline for the whole job, not a fresh one a
      worker, and
  (b) kill-everything cleanup: a worker that fails or wedges must never
      strand its siblings, which would otherwise wait in a collective for a
      peer that is gone.

child_env gives a worker one torch and one OpenMP thread: the ranks of a
gloo job share the host's cores with each other (and, in the test suite,
with the other test workers), and torch's default of a thread a core
oversubscribes it.  Stdlib-only, as fdt's.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time


def free_port() -> int:
    """An OS-assigned free TCP port for a process group's rendezvous."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def child_env(threads: int = 1, base: dict | None = None) -> dict:
    """Environment for a worker: `threads` OpenMP (and so torch intra-op)
    threads, and MKL's the same."""
    env = dict(os.environ if base is None else base)
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(threads)
    return env


class WorkerFailure(RuntimeError):
    """One worker of a multi-process job exited nonzero (its siblings were
    killed at once: a dead peer only wedges their collectives)."""

    def __init__(self, index: int, returncode: int, stdout: str, stderr: str):
        self.index = index
        self.returncode = returncode
        self.stdout = stdout
        self.stderr = stderr
        super().__init__(
            f"worker {index} exited rc={returncode}:\n{stderr[-3000:]}")


def run_workers(cmds: list, timeout: float | None, env: dict | None = None,
                cwd: str | None = None, capture: bool = True) -> list:
    """Run one process per argv in `cmds` under a SHARED deadline.

    Returns [(returncode, stdout, stderr)] in cmd order, all rc 0.  Raises
    WorkerFailure (with the guilty worker's output) as soon as ANY worker
    exits nonzero, and subprocess.TimeoutExpired once the shared deadline
    (`timeout` seconds; None: no deadline) passes.  On every exit path all
    workers are killed and reaped.

    With `capture`, a worker's output goes to temp FILES, not pipes: a
    sibling Popen holds duplicates of an earlier worker's pipe write-ends, so
    reading an exited worker's pipe can block until every later sibling
    exits, and a chatty worker would stall on a full pipe buffer; poll()
    needs only waitpid.  Without it the workers write to this process's
    stdout and stderr, and the strings returned are empty.
    """
    import tempfile
    deadline = None if timeout is None else time.monotonic() + timeout
    procs = []

    def outputs(fo, fe):
        if fo is None:
            return "", ""
        fo.seek(0)
        fe.seek(0)
        return fo.read(), fe.read()

    try:
        for c in cmds:
            fo = tempfile.TemporaryFile(mode="w+") if capture else None
            fe = tempfile.TemporaryFile(mode="w+") if capture else None
            procs.append((subprocess.Popen(c, stdout=fo, stderr=fe, text=True,
                                           env=env, cwd=cwd), fo, fe))
        while True:
            codes = [p.poll() for p, _, _ in procs]
            bad = next((i for i, c in enumerate(codes)
                        if c is not None and c != 0), None)
            if bad is not None:
                for q, _, _ in procs:
                    if q.poll() is None:
                        q.kill()
                        q.wait()
                _, fo, fe = procs[bad]
                raise WorkerFailure(bad, codes[bad], *outputs(fo, fe))
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(cmds, timeout)
            time.sleep(0.2)
        return [(p.returncode, *outputs(fo, fe)) for p, fo, fe in procs]
    finally:
        for p, fo, fe in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            for f in (fo, fe):
                if f is not None:
                    f.close()


def python_workers(args_per_worker: list, timeout: float | None,
                   env: dict | None = None, cwd: str | None = None,
                   capture: bool = True) -> list:
    """run_workers for sys.executable children (the common case)."""
    return run_workers([[sys.executable, *a] for a in args_per_worker],
                       timeout, env=env, cwd=cwd, capture=capture)
