"""The kernels' build under several processes at once, on the CPU.

Two processes ask ``ops/_build.build_all`` for the same source together,
as the ranks of a local gang do at first use.  The compiler is a fake
``nvcc`` (found through ``CUDA_HOME``) that sleeps, records its run and
writes its output file: the source must be compiled once, by the process
that took the build lock, and both must get the same complete library.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({runs!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(1.0)
with open(out, "w") as f:
    f.write("library of " + sys.argv[-1])
"""

BUILD_SCRIPT = r"""
import json, sys
from pathlib import Path
from kubeflow_tpu_torch.ops import _build

_build.CSRC = Path(sys.argv[1])
_build.BUILD_DIR = Path(sys.argv[2])
path = _build.build_all(["k"])["k"]
print(json.dumps({"path": str(path), "text": path.read_text(),
                  "builds": _build.BUILDS.get()}))
"""


def test_two_processes_build_a_source_once(tmp_path):
    csrc, build, runs = tmp_path / "csrc", tmp_path / "build", tmp_path / "runs"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, runs=str(runs)))
    nvcc.chmod(0o755)
    env = {**os.environ, "CUDA_HOME": str(tmp_path / "cuda")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, str(csrc), str(build)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert len(runs.read_text().splitlines()) == 1      # compiled once
    assert sorted(o["builds"] for o in outs) == [0, 1]
    assert outs[0]["path"] == outs[1]["path"]
    assert all(o["text"] == f"library of {csrc / 'k.cu'}" for o in outs)
    # only the library, its compiler log and the lock remain
    names = sorted(p.name for p in build.iterdir())
    assert len(names) == 3 and "k.lock" in names
    assert not [n for n in names if n.endswith(".tmp")]
