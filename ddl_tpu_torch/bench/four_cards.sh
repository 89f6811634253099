#!/bin/bash
# Four cards of one host.  From the repo root:
#
#     bash ddl_tpu_torch/bench/four_cards.sh [PART ...]
#
# PART is one of (default: pod dp pp):
#   pod     the two-host x two-rank dp pod crash drill over NCCL
#           (bench/pod.py: host 0 on cards 0,1, host 1 on cards 2,3)
#   dp      bench/dp.py at 1, 2 and 4 ranks with parity
#   pp      bench/pp.py with parity: pp at (1, 2) and dp_pp at (2, 2)
#   zero    bench/dp.py --zero at 2 and 4 ranks with parity: ZeRO-1 against
#           the replicated step in each world, both timed in turns, and
#           each rank's optimizer bytes
#   ab=DIR  the dp step at 2 and 4 ranks (bench/dp.py, no parity) in the
#           tree unpacked at DIR (another commit of this repo, e.g. the
#           parent: git archive) and in this one, in turns: DIR, this,
#           this, DIR
#
# The whole output goes to $FOUR_CARDS_LOG (default build/four_cards.log);
# the exit code is 1 when any part failed.
set -o pipefail
log=$(realpath -m "${FOUR_CARDS_LOG:-build/four_cards.log}")
mkdir -p "$(dirname "$log")"
: > "$log"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$log"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' \
    | tee -a "$log"
rc=0
run() {
    echo "=== $*" | tee -a "$log"
    local t0=$SECONDS
    "$@" 2>&1 | tee -a "$log"
    local r=${PIPESTATUS[0]}
    echo "=== exit $r after $((SECONDS - t0)) s" | tee -a "$log"
    [ "$r" = 0 ] || rc=1
}
# every rank loads the kernels the build leaves in build/ddl_tpu_torch/
run python -c 'from ddl_tpu_torch.ops import _build; print(_build.build())'
here=$PWD
for part in "${@:-pod dp pp}"; do
    for p in $part; do
        case "$p" in
            pod) run python -m ddl_tpu_torch.bench.pod --devices 0,1:2,3 ;;
            dp) run python -m ddl_tpu_torch.bench.dp --ranks 1,2,4 --parity ;;
            pp) run python -m ddl_tpu_torch.bench.pp --parity ;;
            zero) run python -m ddl_tpu_torch.bench.dp --ranks 2,4 --parity --zero ;;
            ab=*)
                other=${p#ab=}
                # the same CUDA sources build to the same libraries: share them
                mkdir -p "$other/build"
                [ -e "$other/build/ddl_tpu_torch" ] || \
                    ln -s "$here/build/ddl_tpu_torch" "$other/build/ddl_tpu_torch"
                for tree in "$other" "$here" "$here" "$other"; do
                    cd "$tree"
                    run python -m ddl_tpu_torch.bench.dp --ranks 2,4
                done
                cd "$here" ;;
            *) echo "unknown part $p" | tee -a "$log"; rc=1 ;;
        esac
    done
done
exit $rc
