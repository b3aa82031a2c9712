"""Times variants of the self k-NN kernel on one CUDA card.

    python3 scripts/knn_variants.py [--parent DIR] [--stage] [--sass DIR]
                                    [NAME ...]

Each variant is a copy of `puflow_torch/` and `chip_smoke.py` under
`runs/knn_variants/` (gitignored) with one change to `csrc/knn.cu` (the
`parent_` variants change a copy of the `--parent` checkout instead); all
are built side by side, then each runs in its own process on the main
path's patches: 32, 256 and 1,024 patches of 256 points (1, 8 and 32
clouds, `chip_smoke.py:main_path_patches`), k = 16. For each it prints
the registers, spill stores and stack of every instantiation of
`knn_self_kernel` (`nvcc -Xptxas -v`), whether its indices equal
`knn_self_plain`'s (at each size, on an integer grid with many ties and
on patches whose second half repeats the first), whether two runs are
bit-equal, the ms of a call at each size (CUDA events, three windows of
10 after a warm-up), and whether the folded pipeline's output on
`chip_smoke.py`'s clouds at 8 and 32 clouds is bit-equal to the first
copy's (with `--parent`, the parent's). The `diag_` variants drop or
count work and fail the equality check (both run the exact walk alone, without
the narrow keys): `diag_no_list` computes every distance and keeps no
list; `diag_count` writes into slots 0-2 of each
row the voted warp-steps in which a lane inserts, the voted steps walked,
and the steps in which a lane's key beats the front half of its list
(the whole chain runs), and the script prints the shares. `--stage` then
splits the self k-NN stage of the folded pipeline at 32 clouds
(`chip_smoke.py:pipeline_staged`) in each copy that is not a diagnostic:
the device time from the stage's start to the launch and of the launch,
the host time before the wrapper and in it, whether the card had drained
its queue when the host reached the stage, the wrapper and the bare C
entry timed back to back, and the kernel's device time in a profiled
pipeline run. `--parent DIR` runs the `puflow_torch/` of another
checkout first (for example `git archive` of the parent commit).
`--sass DIR` writes each copy's SASS (`cuobjdump -sass`) into DIR.
Names pick variants; none runs them all. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "runs" / "knn_variants"
KNN = "puflow_torch/csrc/knn.cu"
K = 16


def swap(old: str, new: str):
    def edit(text: str) -> str:
        if old not in text:
            raise ValueError(f"not found: {old[:60]!r}")
        return text.replace(old, new)
    return edit


# the parent kernel (one block a patch, a thread a query, a (distance,
# index) insertion over two arrays)
P_INSERT = "      if (d < bd[kMaxK - 1]) {"
P_INIT = """      bi[j] = INT_MAX;
    }
"""
P_STORE = "      if (j < k) o[j] = bi[j];"

# the kernel of this checkout
INSERT = "  insert(list, key);\n"
ROW = "rows[g * k + j] = static_cast<int64_t>(static_cast<uint32_t>(list[j]));"
LANES = "  const int lanes = queries >= (1 << 16) ? 1 : 4;"
PREFILL = "    if (exact && full >= KL / kS) {"
NARROW = "    if constexpr (L == 1 && KL == kMaxK) {"
NO_NARROW = (KNN, swap(NARROW, "    if constexpr (false) {"))
INSERT_BODY = """  if (__any_sync(0xffffffffu, key < list[KL - 1])) {
    if (kHalf && !__any_sync(0xffffffffu, key < list[kHalf - 1])) {
#pragma unroll
      for (int j = kHalf; j < KL; ++j) order2(list[j], key);
    } else {
#pragma unroll
      for (int j = 0; j < KL; ++j) order2(list[j], key);
    }
  }
"""
NARROW_BODY = """  if (__any_sync(0xffffffffu, key < a[kNarrow - 1])) {
    if (!__any_sync(0xffffffffu, key < a[kHalf - 1])) {
#pragma unroll
      for (int j = kHalf; j < kNarrow; ++j) order2(a[j], key);
    } else {
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) order2(a[j], key);
    }
  }
"""
FULL_CHAIN = """#pragma unroll
  for (int j = 0; j < KL; ++j) order2(list[j], key);
"""
COUNT = [
    NO_NARROW,
    (KNN, swap("__device__ __forceinline__ void consider(",
               "__device__ __forceinline__ void consider(int (&count)[3],\n")),
    (KNN, swap("(pts, q, list", "(count, pts, q, list")),
    (KNN, swap("  uint64_t list[KL];\n",
               "  uint64_t list[KL];\n  int count[3] = {0, 0, 0};\n")),
    (KNN, swap(INSERT, "  ++count[1];\n  count[0] += __any_sync(0xffffffffu, "
                       "key < list[KL - 1]);\n  count[2] += __any_sync("
                       "0xffffffffu, key < list[KL > 1 ? KL / 2 - 1 : 0]);\n"
                       + INSERT)),
    (KNN, swap(ROW, "rows[g * k + j] = j < 3 ? count[j] : "
                    "static_cast<int64_t>(static_cast<uint32_t>(list[j]));")),
]

STAGE_IN_ORDER = (KNN, swap(
    "  stage_sorted(src, n, pts, words);\n",
    "  for (int i = threadIdx.x; i < n; i += kThreads)\n"
    "    pts[i] = make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2],"
    "\n                         __int_as_float(i));\n"))

# (base, edits): base "tree" copies this checkout, "parent" the --parent one
VARIANTS = {
    "kept": ("tree", []),
    "lanes_1": ("tree", [(KNN, swap(LANES, "  const int lanes = 1;"))]),
    "lanes_4": ("tree", [(KNN, swap(LANES, "  const int lanes = 4;"))]),
    # the patch staged in index order: no Morton sort
    "index_order": ("tree", [STAGE_IN_ORDER]),
    # with the exact walk alone: every candidate runs the whole chain
    "no_vote": ("tree", [NO_NARROW, (KNN, swap(INSERT_BODY, FULL_CHAIN))]),
    # with the exact walk alone: one vote against the last entry, then the
    # whole chain
    "one_chain": ("tree", [NO_NARROW, (KNN, swap(
        INSERT_BODY, "  if (__any_sync(0xffffffffu, key < list[KL - 1])) {\n"
                     + FULL_CHAIN + "  }\n"))]),
    # with the exact walk alone: the first KL keys inserted one by one
    "no_prefill": ("tree", [NO_NARROW,
                            (KNN, swap(PREFILL, "    if (false) {"))]),
    # the exact walk alone: no narrow keys
    "exact_walk": ("tree", [NO_NARROW]),
    "diag_no_list": ("tree", [
        NO_NARROW,
        (KNN, swap(PREFILL, "    if (false) {")),
        (KNN, swap(INSERT, "  list[0] = kmin(list[0], key);\n"))]),
    "diag_count": ("tree", COUNT),
    # the narrow walk's distances and keys, no list
    "diag_narrow_no_list": ("tree", [(KNN, swap(
        NARROW_BODY, "  a[kNarrow - 1] = min(a[kNarrow - 1], key);\n"))]),
    # the staging in index order and the output alone: no sort, no walk
    "diag_stage_only": ("tree", [
        (KNN, swap("  if (w0 < n) {", "  if (false) {")), STAGE_IN_ORDER]),
    # the staging, sort and output alone: no walk
    "diag_no_walk": ("tree", [(KNN, swap("  if (w0 < n) {", "  if (false) {"))]),
    "parent_diag_no_list": ("parent", [
        (KNN, swap(P_INSERT, "      if (d < bd[0]) {\n        bd[0] = d;\n"
                             "        bi[0] = c;\n      }\n      if (false) {"))]),
    "parent_diag_count": ("parent", [
        (KNN, swap(P_INIT, P_INIT + "    int inserts = 0, steps = 0;\n")),
        (KNN, swap(P_INSERT, "      ++steps;\n      if (__any_sync(0xffffffffu,"
                             " d < bd[kMaxK - 1])) ++inserts;\n" + P_INSERT)),
        (KNN, swap(P_STORE, "      if (j < k) o[j] = j == 0 ? inserts : "
                            "j == 1 ? steps : bi[j];"))]),
}


def prepare(name: str, src: Path, edits) -> Path:
    """A copy of ``src``'s package and chip_smoke.py with ``edits``."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src / "puflow_torch", d / "puflow_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(src / "chip_smoke.py", d)
    for rel, edit in edits:
        path = d / rel
        path.write_text(edit(path.read_text()))
    return d


def run_in(d: Path, args: list[str]) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(d))
    return subprocess.Popen([sys.executable, *args], cwd=d, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def ptxas(d: Path) -> subprocess.Popen:
    """`nvcc -Xptxas -v` of the copy's k-NN source."""
    sys.path.insert(0, str(ROOT))
    from puflow_torch.ops import _build

    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(d / KNN), "-o", os.devnull], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def sass(d: Path, name: str, dest: Path) -> None:
    """The SASS of the copy's k-NN source, into `dest/NAME.sass`."""
    from puflow_torch.ops import _build

    cubin = d / "knn.cubin"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-cubin", "-o",
                    str(cubin), str(d / KNN)], check=True)
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    dest.mkdir(parents=True, exist_ok=True)
    with open(dest / f"{name}.sass", "w") as f:
        subprocess.run([str(tool), "-sass", str(cubin)], stdout=f,
                       check=True)


def registers(out: str) -> str:
    """Registers and spill stores of each instantiation of
    `knn_self_kernel` (its template arguments from the mangled name)."""
    lines = out.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or "knn_self_kernel" \
                not in line:
            continue
        args = re.search(r"knn_self_kernelI((?:L\w+?E)+)E", line)
        label = (",".join(re.findall(r"L\w+?(\d+)E", args.group(1)))
                 if args else "")
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        stack = re.search(r"(\d+) bytes stack frame", info)
        found.append(f"<{label}> {regs.group(1) if regs else '?'} regs "
                     f"{spill.group(1) if spill else '?'} B spilled "
                     f"{stack.group(1) if stack else '?'} B stack")
    return "; ".join(found) or "regs ?"


def measure(label: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from puflow_torch.ops.knn import knn_self, knn_self_plain

    rng = np.random.RandomState(cs.SEED)
    with torch.no_grad():
        sizes = {m: cs.main_path_patches(m // 32) for m in (32, 256, 1024)}
        x = sizes[256]
        grid = torch.from_numpy(
            rng.randint(0, 7, x.shape).astype(np.float32)).cuda()
        cases = {f"{m} patches": p for m, p in sizes.items()}
        cases.update({"grid": grid,
                      "repeated": cs.repeated_half(rng, *x.shape[:2])})
        differ = {}
        for name, p in cases.items():
            got, ref = knn_self(p, K), knn_self_plain(p, K)
            differ[name] = int((got != ref).sum())
        same = torch.equal(knn_self(x, K), knn_self(x, K))
        ms = {m: [cs.time_ms(lambda p=p: knn_self(p, K), 10)
                  for _ in range(3)] for m, p in sizes.items()}
        extra = ""
        if "count" in label:
            share = []
            for m, p in sizes.items():
                c = knn_self(p, K)[..., :3].double().sum((0, 1))
                share.append(f"{m}: {c[0]:.0f} and {c[2]:.0f} of {c[1]:.0f} "
                             f"({c[0] / c[1]:.4f}, {c[2] / c[1]:.4f})")
            extra = (", voted steps that insert and that run the whole "
                     "chain " + "; ".join(share))
        # the folded pipeline on chip_smoke.py's clouds at 8 and 32 clouds
        # (not with a diagnostic's indices, which may point anywhere)
        if "diag" not in label:
            _, folded = cs.seeded_models()
            torch.save([cs.pipeline_staged(
                folded, cs.synthetic_clouds(b, cs.SEED + b))[0].cpu()
                for b in (8, 32)], "pipeline_out.pt")
    equal = all(v == 0 for v in differ.values())
    print(f"{label}: indices equal {equal} "
          f"({', '.join(f'{k} {v}' for k, v in differ.items())} differ), "
          f"rerun equal {same}, ms at 32 patches "
          f"{' '.join(f'{t:.4f}' for t in ms[32])}, at 256 "
          f"{' '.join(f'{t:.4f}' for t in ms[256])}, at 1024 "
          f"{' '.join(f'{t:.4f}' for t in ms[1024])}{extra}", flush=True)


def same_pipeline(d: Path, first: Path) -> str:
    """Whether a copy's folded pipeline outputs are bit-equal to the
    first copy's."""
    import torch

    if not (d / "pipeline_out.pt").exists():
        return "folded pipeline not run"
    a = torch.load(d / "pipeline_out.pt")
    b = torch.load(first / "pipeline_out.pt")
    equal = all(torch.equal(u, v) for u, v in zip(a, b))
    return f"folded pipeline bit-equal to {first.name}'s: {equal}"


def stage(label: str) -> None:
    """Splits the self k-NN stage of the folded pipeline at 32 clouds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from puflow_torch.ops import _build
    from puflow_torch.ops.knn import knn_self

    _, folded = cs.seeded_models()
    pc = cs.synthetic_clouds(32, cs.SEED + 32)
    rec = {}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e, time.perf_counter()

    def mark(name):
        rec[name] = event()

    def knn(p, k):
        rec["drained"] = rec["patch_knn"][0].query()
        rec["pre"] = event()
        out = knn_self(p, k)
        rec["post"] = event()
        return out

    ops = dict(cs.KERNEL_OPS, knn_self=knn)
    rows = []
    with torch.no_grad():
        for i in range(6):
            rec.clear()
            cs.pipeline_staged(folded, pc, ops, mark)
            torch.cuda.synchronize()
            if i == 0:
                continue
            (e0, h0), (e1, h1) = rec["patch_knn"], rec["pre"]
            (e2, h2), (e3, _) = rec["post"], rec["knn_self"]
            rows.append({"stage": e0.elapsed_time(e3),
                         "to launch": e0.elapsed_time(e1),
                         "launch": e1.elapsed_time(e2),
                         "host before": (h1 - h0) * 1e3,
                         "host wrapper": (h2 - h1) * 1e3,
                         "drained": float(rec["drained"])})
        med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        x = cs.main_path_patches(32)
        M, n, _ = x.shape
        wrapper = cs.time_ms(lambda: knn_self(x, K), 10)
        lib = _build.library()
        out = torch.empty((M, n, K), dtype=torch.int64, device=x.device)
        stream = _build.stream_ptr(x.device)
        bare = cs.time_ms(lambda: lib.puflow_knn_self(
            x.data_ptr(), M, n, K, out.data_ptr(), stream), 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            knn_self(x, K)
        enqueue = (time.perf_counter() - t0) * 10
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cs.pipeline_staged(folded, pc)
            torch.cuda.synchronize()
        traced = [e.time_range.end - e.time_range.start
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "knn_self_kernel" in e.name]
    print(f"{label} stage at 32 clouds (median of 5): "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
          + f" (ms; drained: share of runs); [{M}, {n}] back to back: "
          f"wrapper {wrapper:.4f} ms, bare C entry {bare:.4f} ms, host "
          f"enqueue {enqueue:.4f} ms a wrapper call; profiled pipeline: "
          f"knn_self_kernel {sum(traced) / 1e3:.4f} ms device in "
          f"{len(traced)} launch(es)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    ap.add_argument("--parent", type=Path, help="another checkout to time")
    ap.add_argument("--stage", action="store_true",
                    help="also split the pipeline's self k-NN stage")
    ap.add_argument("--sass", type=Path, metavar="DIR",
                    help="write each copy's SASS into DIR")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--stage-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        return 0
    if args.stage_of:
        stage(args.stage_of)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("knn_variants: needs a CUDA card")
    names = args.names or [n for n, (base, _) in VARIANTS.items()
                           if base == "tree" or args.parent]
    dirs = {}
    if args.parent:
        dirs["parent"] = prepare("parent", args.parent.resolve(), [])
    for name in names:
        base, edits = VARIANTS[name]
        if base == "parent" and not args.parent:
            raise SystemExit(f"{name}: needs --parent")
        dirs[name] = prepare(
            name, args.parent.resolve() if base == "parent" else ROOT, edits)
    builds = {name: run_in(d, ["-c", "from puflow_torch.ops import _build; "
                                     "_build.build()"])
              for name, d in dirs.items()}
    regs = {name: ptxas(d) for name, d in dirs.items()}
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{out}")
    regs = {name: registers(p.communicate()[0]) for name, p in regs.items()}
    if args.sass:
        for name, d in dirs.items():
            sass(d, name, args.sass.resolve())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    script = str(Path(__file__).resolve())
    first = next(iter(dirs.values()))
    for name, d in dirs.items():
        proc = run_in(d, [script, "--measure", name])
        out, _ = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith(name + ":")]
        if lines and not proc.returncode:
            print(f"{lines[-1]} | {regs[name]} | {same_pipeline(d, first)}",
                  flush=True)
        else:
            print(f"{name}: failed\n{out[-2000:]}", flush=True)
    if args.stage:
        for name, d in dirs.items():
            if "diag" in name:
                continue
            proc = run_in(d, [script, "--stage-of", name])
            out, _ = proc.communicate()
            lines = [ln for ln in out.splitlines() if ln.startswith(name)]
            print(lines[-1] if lines and not proc.returncode
                  else f"{name} stage: failed\n{out[-2000:]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
