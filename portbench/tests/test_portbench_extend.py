"""A later change adds a kernel's count and a per-layer metric by adding
two files: in a copy of the benchmark, a new ``counts/<kernel>.py`` and
a new ``metrics/<name>.py`` are found by name and read in a traced run,
with no file that was there edited."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

from portbench.manifest import ROOT

COUNT = '''
"""Every call of paged_decode counts one millisecond."""
ENTRY = ("repro_torch.kernels.paged_attention.ops", "paged_decode")


def shapes(a, probe):
    return dict(slots=a["q"].shape[0])


def least_ms(call):
    return 1.0
'''

METRIC = '''
"""Counted milliseconds per traced call of paged_decode."""
LAYER, UNIT, SOURCE, MOVES = ("paged attention", "ms", "device_trace",
                              "prompt_tokens_per_s")
RANGES = ("kx",)


def read(run):
    calls = run.traced["range_calls"]["kx"]
    return run.least_ms["kx"] / calls if calls else None
'''

RUN = '''
import json
import torch
torch.set_num_threads(1)
from portbench import run as R
from portbench.manifest import Manifest, load_reader
from portbench.tests.conftest import tiny_serve
conf, traffic, limits = tiny_serve(Manifest())
out = R.run_cell(conf, traffic, limits, seed=3, seconds=1.0, trace=True,
                 device="cpu", readers=["kx.per_call"])
print(json.dumps({"value": load_reader("kx.per_call").read(out["run"]),
                  "calls": out["run"].traced["range_calls"]["kx"],
                  "harness": R.__file__, "correct": out["correct"]}))
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_count_and_metric_files_are_read(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)
    (tmp_path / "portbench/counts/kx.py").write_text(textwrap.dedent(COUNT))
    (tmp_path / "portbench/metrics/kx.per_call.py").write_text(
        textwrap.dedent(METRIC))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    got = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["harness"].startswith(str(tmp_path))
    assert line["correct"] and line["calls"] > 0
    assert line["value"] == 1.0
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "portbench/counts/kx.py", "portbench/metrics/kx.per_call.py"]
