"""The spawn helper of the port's test files (``tests/_torch_spawn.py``):
a job that outlives its limit is reported as killed at its limit, with
its name, limit and seconds, and not as the parity failure of a test that
reads its missing output."""

import os
import sys
import time

import pytest

from _torch_spawn import run_script, spawn

LIMIT = 2


def _sleep(seconds):
    time.sleep(seconds)


def _write(path):
    with open(os.path.join(path, f"rank{os.environ['RANK']}"), "w") as f:
        f.write(os.environ["WORLD_SIZE"])


def _exit(code):
    sys.exit(code)


def _environment(path):
    import torch
    with open(path, "w") as f:
        f.write(f"{os.environ.get('OMP_WAIT_POLICY')} "
                f"{torch.get_num_threads()}")


def test_a_job_past_its_limit_is_reported_killed_at_it(tmp_path):
    jobs = spawn({"sleeper": (_sleep, 0, (60,))}, LIMIT)
    assert jobs.codes["sleeper"] == [-9]
    assert LIMIT <= jobs.seconds["sleeper"] < 30
    with pytest.raises(pytest.fail.Exception,
                       match=r"^job 'sleeper' was killed at its limit of 2 s "
                             r"after [0-9.]+ s$"):
        jobs.check("sleeper")


def test_jobs_that_end_pass_their_check(tmp_path):
    jobs = spawn({"ranks": (_write, 2, (str(tmp_path),)),
                  "fails": (_exit, 0, (3,))}, 60, lambda: "meanwhile")
    jobs.check("ranks")
    assert jobs.found == "meanwhile" and jobs.codes["ranks"] == [0, 0]
    assert sorted(os.listdir(tmp_path)) == ["rank0", "rank1"]
    assert (tmp_path / "rank1").read_text() == "2"
    with pytest.raises(pytest.fail.Exception,
                       match=r"job 'fails' exited with \[3\] after"):
        jobs.check("fails")


def test_a_script_past_its_limit_is_reported_killed_at_it():
    with pytest.raises(pytest.fail.Exception,
                       match=r"job 'nap' was killed at its limit of 2 s "
                             r"after [0-9.]+ s"):
        run_script("nap", [sys.executable, "-c",
                           "import time; time.sleep(60)"], LIMIT)
    proc = run_script("threads", [sys.executable, "-c",
                                  "import os; print(os.environ['OMP_NUM_"
                                  "THREADS'], os.environ['OMP_WAIT_POLICY'])"],
                      60)
    assert proc.returncode == 0 and proc.stdout.split() == ["2", "PASSIVE"]


def test_spawned_children_run_two_passive_threads(tmp_path):
    """A spawned child has two torch threads and passive OpenMP threads;
    this process's environment is left as it was."""
    before = os.environ.get("OMP_WAIT_POLICY")
    path = tmp_path / "env"
    spawn({"env": (_environment, 0, (str(path),))}, 60).check("env")
    assert path.read_text() == "PASSIVE 2"
    assert os.environ.get("OMP_WAIT_POLICY") == before
