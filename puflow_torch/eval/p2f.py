"""Runs the native point-to-mesh distance tool (`native/p2f`).

The port's counterpart of `puflow_tpu.eval.p2f`, for the same tool and
with the same `run_p2f`. The port builds its own binary from
`native/p2f/p2f.cpp` with the tool's Makefile flags into the git-ignored
`puflow_torch/_build/`, named by a hash of the source, at first use; it
never writes into `native/p2f/`. A missing compiler or a failed build
raises with the compiler's message: the P2F and uniformity columns of
`evaluation.csv` are never left empty for want of the tool.

Run it once per (mesh, prediction) pair before `puflow_torch.cli.evaluate`,
which then picks up the `<pred>_point2mesh_distance.xyz` side files (and,
with ``uniform=True``, the disk side-files of the uniformity metric).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

from puflow_torch.ops._build import BUILD_DIR, build_once, digest

P2F_SRC = (Path(__file__).resolve().parent.parent.parent / "native" / "p2f"
           / "p2f.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-pthread", "-Wall"]   # native/p2f/Makefile


def ensure_built() -> str:
    """Build the tool unless a binary of this source and these flags
    exists; returns its path. Raises `RuntimeError` with the compiler's
    output if there is no C++ compiler or the build fails."""
    def compile_(tmp: Path) -> None:
        cxx = shutil.which("g++")
        if not cxx:
            raise RuntimeError("no C++ compiler (g++) to build the p2f tool "
                               f"from {P2F_SRC}")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                               str(P2F_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the p2f tool failed "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")

    out = BUILD_DIR / f"p2f_{digest(CXX_FLAGS, [P2F_SRC])}"
    return str(build_once(out, compile_)[0])


def run_p2f(mesh_off: str, pred_xyz: str, n_threads: int | None = None,
            uniform: bool = False, seed: int = 2021, samples: int = 1000):
    """Compute point-to-mesh distances; writes the side file, returns
    (mean, std) parsed from the tool's stdout.

    With ``uniform=True`` the tool also emits the disk-density side-files
    (`_disk_idx.txt`, `_radius.txt`, `_point2mesh_distance.txt`) that the
    uniformity metric consumes — the reference's equivalent code path is
    dead (`evaluation.cpp:74-114` never called from its main)."""
    cmd = [ensure_built(), mesh_off, pred_xyz]
    if n_threads:
        cmd.append(str(n_threads))
    if uniform:
        cmd += ["--uniform", "--seed", str(seed), "--samples", str(samples)]
    out = subprocess.run(cmd, check=True, capture_output=True,
                         text=True).stdout
    vals = {}
    for line in out.splitlines():
        if ":" in line:
            k, v = line.split(":")
            vals[k.strip()] = float(v)
    return vals.get("p2f avg"), vals.get("p2f std")


if __name__ == "__main__":
    print(ensure_built())
