#!/usr/bin/env bash
# The evaluation protocol of the PyTorch port on one CUDA card, on
# synthetic fixtures: generate meshes + clouds -> upsample x4 with a
# checkpoint (`puflow_torch.cli.upsample`) -> point-to-mesh distances and
# the uniformity side-files (`native/p2f`, built by `puflow_torch.eval.p2f`)
# -> evaluation.csv (`puflow_torch.cli.evaluate`). The port's counterpart of
# scripts/eval_fixtures.sh + scripts/eval_pu1k.sh (reference
# evaluation/eval_pu1k.sh), without the unpublished dataset downloads.
#
# usage: scripts/eval_fixtures_torch.sh <checkpoint> [workdir] [n_shapes]
#            [n_input] [n_gt] [upsample flags...]
#   checkpoint: a reference .pt state_dict or a native .npz (required)
#   workdir: where fixtures, predictions and evaluation.csv go; by
#   default a new directory under $TMPDIR (printed at the start)
#   n_input/n_gt default to the PU1K protocol (2048 -> 8192); pass 5000
#   20000 for the PU-GAN protocol shapes (reference evaluation/eval_pugan.sh).
#   Flags after n_gt go to the upsample CLI, e.g. `--model cnf`.
# Prints each stage's wall seconds as `stage <name>: <s> s`.
set -euo pipefail

CKPT=${1:?checkpoint (.pt or .npz)}
WORK=${2:-$(mktemp -d "${TMPDIR:-/tmp}/puflow_eval.XXXXXX")}
N_SHAPES=${3:-2}
N_INPUT=${4:-2048}
N_GT=${5:-8192}
UPSAMPLE_FLAGS=("${@:6}")

# paths relative to the caller's directory, before the cd to the root
CKPT=$(realpath "$CKPT")
mkdir -p "$WORK"
WORK=$(cd "$WORK" && pwd)
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
cd "$ROOT"
echo "workdir $WORK"

now() { date +%s.%N; }
stage() { awk -v a="$2" -v b="$(now)" -v n="$1" \
    'BEGIN { printf "stage %s: %.3f s\n", n, b - a }'; }

T0=$(now)
T=$T0
python scripts/make_fixtures.py "$WORK" "$N_SHAPES" "$N_INPUT" "$N_GT"
stage fixtures "$T"

T=$(now)
BATCH=$(( N_SHAPES < 16 ? N_SHAPES : 16 ))
python -m puflow_torch.cli.upsample --source "$WORK/input" \
    --target "$WORK/pred" --checkpoint "$CKPT" --up_ratio 4 \
    --batch "$BATCH" --device cuda ${UPSAMPLE_FLAGS[@]+"${UPSAMPLE_FLAGS[@]}"}
stage upsample "$T"

T=$(now)
P2F=$(python -m puflow_torch.eval.p2f)
for pred in "$WORK/pred"/*.xyz; do
    name=$(basename "$pred" .xyz)
    mesh="$WORK/mesh/$name.off"
    if [[ ! -f "$mesh" ]]; then
        echo "error: no mesh $mesh for the prediction $name" >&2
        exit 1
    fi
    "$P2F" "$mesh" "$pred" --uniform
done
stage p2f "$T"

T=$(now)
python -m puflow_torch.cli.evaluate --pred "$WORK/pred" --gt "$WORK/gt" \
    --save_path "$WORK/results" --device cuda
stage evaluate "$T"
stage protocol "$T0"
head -3 "$WORK/results/evaluation.csv"
tail -2 "$WORK/results/evaluation.csv"
