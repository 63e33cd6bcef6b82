"""Processes that the port's test files start: jobs of spawned processes
(ranks of ``gloo`` on ``localhost``, or one process without a group) and
scripts in a fresh interpreter.  Each has a time limit that guards against
a hang; it is no tolerance.  A job killed at its limit fails the tests
that read it with one message that names the job, its limit and its
seconds, not with a missing file or a parity error.  Each job prints a
``[spawn]`` line with its seconds (``pytest -rP`` shows them: how the
limits were measured).
"""

import contextlib
import importlib
import io
import os
import pickle
import socket
import subprocess
import threading
import time
from multiprocessing.connection import wait

import pytest
import torch
import torch.multiprocessing as mp

# The children's torch and BLAS threads: the test lane runs six pytest
# workers on eight cores, each with its own torch and XLA thread pools, and
# a child with a thread a core ran 15 times slower there than alone.
CHILD_THREADS = 2
# and their OpenMP threads sleep at once when a parallel region ends:
# torch's OpenMP (libgomp) otherwise spins up to 300,000 times at the
# barrier, and on a loaded host a spinning thread takes the core its
# partner needs (four such steps on four cores took twice the CPU time and
# twice the wall time they take passive)
CHILD_ENV = {"OMP_WAIT_POLICY": "PASSIVE"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, world, rank, port, args):
    """A spawned process: ``fn(*args)`` at ``CHILD_THREADS`` torch threads;
    with a ``world``, as that rank of a group on ``localhost:port``
    (``torchrun``'s environment)."""
    torch.set_num_threads(CHILD_THREADS)
    if world:
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
    fn(*args)


def _log(limit, seconds, codes):
    for tag in seconds:
        print(f"[spawn] job {tag!r}: {seconds[tag]:.1f} s of its {limit} s "
              f"limit, exit codes {codes[tag]}")


class Jobs:
    """What ``spawn`` returns: each job's exit codes (a rank killed at the
    limit gives -9) and seconds, the limit, and what ``meanwhile``
    returned (``found``)."""

    def __init__(self, limit, codes, seconds, killed, found):
        self.limit, self.codes, self.seconds = limit, codes, seconds
        self.killed, self.found = killed, found

    def check(self, *tags):
        """Fail with one message unless every rank of each job in ``tags``
        exited with 0."""
        bad = []
        for tag in tags:
            if tag in self.killed:
                bad.append(f"job {tag!r} was killed at its limit of "
                           f"{self.limit} s after {self.seconds[tag]:.1f} s")
            elif any(self.codes[tag]):
                bad.append(f"job {tag!r} exited with {self.codes[tag]} "
                           f"after {self.seconds[tag]:.1f} s")
        if bad:
            pytest.fail("; ".join(bad), pytrace=False)


def spawn(groups, limit, meanwhile=lambda: None) -> Jobs:
    """Start ``groups`` (``{tag: (function, world, args)}``, ``world``
    ranks each; 0: one process without a group) at once, with
    ``CHILD_ENV``, run ``meanwhile()`` here, and kill what still runs
    ``limit`` seconds after the start.  The functions must be importable
    (a test module's)."""
    ctx = mp.get_context("spawn")
    procs, tags = [], []
    for tag, (fn, world, args) in groups.items():
        port = free_port()
        for r in range(max(world, 1)):
            procs.append(ctx.Process(target=_entry,
                                     args=(fn, world, r, port, args)))
            tags.append(tag)
    t0 = time.monotonic()
    with pytest.MonkeyPatch.context() as env:     # what the children read
        for k, v in CHILD_ENV.items():
            env.setenv(k, v)
        for p in procs:
            p.start()
    ended, killed = {}, set()

    def watch():
        left = {p.sentinel: p for p in procs}
        while left:
            ready = wait(list(left), max(0.0, t0 + limit - time.monotonic()))
            now = time.monotonic() - t0
            if not ready:                   # the limit: kill what is left
                for p in left.values():
                    p.kill()
                    p.join()
                    ended[p] = now
                    killed.add(p)
                return
            for s in ready:
                ended[left.pop(s)] = now
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        found = meanwhile()
        watcher.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        watcher.join()
        for p in procs:
            p.join()
    codes = {tag: [] for tag in groups}
    seconds = {tag: 0.0 for tag in groups}
    for tag, p in zip(tags, procs):
        codes[tag].append(p.exitcode)
        seconds[tag] = max(seconds[tag], ended.get(p, limit))
    _log(limit, seconds, codes)
    return Jobs(limit, codes, seconds,
                {tag for tag, p in zip(tags, procs) if p in killed}, found)


def _call_entry(fn, args, path):
    with open(path, "wb") as f:
        pickle.dump(fn(*args), f)


def call(name, fn, args, limit, tmp):
    """``fn(*args)`` in a spawned process (``spawn``'s threads and
    environment) and its value back, pickled through a file in the
    directory ``tmp``: a test's heavy torch work runs there with passive
    OpenMP threads, while the pytest worker's own threads spin at the
    barrier (a JAX-side test file loads torch before any port file could
    set the policy).  Fails as ``Jobs.check`` does."""
    path = os.path.join(str(tmp), f"{name}.pickle")
    spawn({name: (_call_entry, 0, (fn, args, path))}, limit).check(name)
    with open(path, "rb") as f:
        return pickle.load(f)


def tool_run(module, argv):
    """``run(argv)`` of the port's tool ``module`` and what it printed (a
    function for ``call``)."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = importlib.import_module(module).run(argv)
    return out, text.getvalue()


def run_script(name, argv, limit, env=None, cwd=None):
    """``argv`` in a child process at ``CHILD_THREADS`` threads (torch,
    OpenMP, BLAS) with ``CHILD_ENV``, killed at ``limit`` seconds: the
    completed process, its output captured.  A child killed at its limit
    fails with the job's ``name``, limit and seconds."""
    env = dict(os.environ if env is None else env, **CHILD_ENV)
    n = str(CHILD_THREADS)
    env.update(OMP_NUM_THREADS=n, MKL_NUM_THREADS=n, OPENBLAS_NUM_THREADS=n)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=limit, env=env, cwd=cwd)
    except subprocess.TimeoutExpired:
        seconds = time.monotonic() - t0
        _log(limit, {name: seconds}, {name: [-9]})
        pytest.fail(f"job {name!r} was killed at its limit of {limit} s "
                    f"after {seconds:.1f} s", pytrace=False)
    _log(limit, {name: time.monotonic() - t0}, {name: [proc.returncode]})
    return proc
