"""The port's native library build (``chanamq_tpu_torch/native_ext.py``).

The port compiles ``native/chanamq_native.cpp`` into its own git-ignored
``chanamq_tpu_torch/_build/`` under a temporary name and renames it into
place, so several processes building at once each load a whole library,
and the reference's ``native/libchanamq_native.so`` is never written.
"""

import os
import shutil
import subprocess
import sys
import time

import pytest

from chanamq_tpu_torch import native_ext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, sys, time
from chanamq_tpu_torch import native_ext
build_dir, go = sys.argv[1], sys.argv[2]
native_ext._BUILD_DIR = build_dir
native_ext._LIB_PATH = os.path.join(build_dir, "libchanamq_native.so")
while not os.path.exists(go):
    time.sleep(0.001)
m = native_ext.NativeTopicMatcher() if native_ext.available() else None
if m is None:
    sys.exit(3)
m.bind("a.*.c", "q1")
m.bind("a.#", "q2")
print(sorted(m.route("a.b.c")))
"""


def test_lib_is_the_ports_own_build():
    assert native_ext._LIB_PATH == os.path.join(
        REPO, "chanamq_tpu_torch", "_build", "libchanamq_native.so")
    assert native_ext._SRC_PATH == os.path.join(
        REPO, "native", "chanamq_native.cpp")


@pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                    reason="no C++ compiler to build the native library")
def test_two_processes_build_at_once_and_both_load(tmp_path):
    """Two processes start building into one empty directory at the same
    moment: both load a whole library that routes, no temporary file is
    left behind, and ``native/`` is untouched."""
    ref_lib = os.path.join(REPO, "native", "libchanamq_native.so")
    ref_before = (os.stat(ref_lib).st_mtime_ns
                  if os.path.exists(ref_lib) else None)
    build_dir = str(tmp_path / "build")
    go = str(tmp_path / "go")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, build_dir, go],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    time.sleep(0.5)  # both children imported and waiting
    open(go, "w").close()
    outs = [p.communicate(timeout=240) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
        assert out.strip() == "['q1', 'q2']", (out, err)
    assert os.listdir(build_dir) == ["libchanamq_native.so"]
    ref_after = (os.stat(ref_lib).st_mtime_ns
                 if os.path.exists(ref_lib) else None)
    assert ref_after == ref_before
