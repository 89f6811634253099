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
#   vit     bench/vit.py (ViT-S/16, batch 64) on one card, at data=4, and at
#           data=2 x pipe=2 under gpipe and 1f1b
#   lm      bench/lm.py at the 124M width (12 heads over 4 K/V heads of 64,
#           vocab 256, flash), batch 4 x 4096: one card, then ring and
#           Ulysses at seq=4 and at data=2 x seq=2 over NCCL, each with
#           --parity (its first steps held to one card's and to f32)
#   lm-pipe bench/lm.py at the 124M training configuration (vocab 50304, 12
#           heads of 64, flash, batch 8 x 1024, 3 windows of 5 steps): one
#           card, then pipe=4 in 8 microbatches and data=2 x pipe=2 in 4,
#           under gpipe and 1f1b, over NCCL
#   lm-tp   bench/lm.py at the 124M training configuration (vocab 50304, 12
#           heads of 64, flash, batch 8 x 1024, 3 windows of 5 steps): one
#           card, then model=4, data=2 x model=2 and pipe=2 x seq=2 (the
#           ring, 1f1b in 4 microbatches), each with --parity, over NCCL
#   vit-tp  bench/vit.py (ViT-S/16, batch 64) on one card and at data=2 x
#           model=2
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
            vit)
                run python -m ddl_tpu_torch.bench.vit
                run python -m ddl_tpu_torch.bench.vit --data 4
                run python -m ddl_tpu_torch.bench.vit --data 2 --pipe 2
                run python -m ddl_tpu_torch.bench.vit --data 2 --pipe 2 --schedule 1f1b ;;
            lm)
                lm="--vocab 256 --kv-heads 4 --flash on --seq-len 4096 --batch 4 --iters 5"
                run python -m ddl_tpu_torch.bench.lm $lm
                for attn in ring ulysses; do
                    run python -m ddl_tpu_torch.bench.lm $lm --seq 4 --attn $attn --parity
                    run python -m ddl_tpu_torch.bench.lm $lm --data 2 --seq 2 --attn $attn \
                        --parity
                done ;;
            lm-pipe)
                lm="--flash on --seq-len 1024 --batch 8 --iters 5 --windows 3"
                run python -m ddl_tpu_torch.bench.lm $lm
                for sch in gpipe 1f1b; do
                    run python -m ddl_tpu_torch.bench.lm $lm --pipe 4 --microbatches 8 \
                        --schedule $sch
                    run python -m ddl_tpu_torch.bench.lm $lm --data 2 --pipe 2 \
                        --microbatches 4 --schedule $sch
                done ;;
            lm-tp)
                lm="--flash on --seq-len 1024 --batch 8 --iters 5 --windows 3"
                run python -m ddl_tpu_torch.bench.lm $lm
                run python -m ddl_tpu_torch.bench.lm $lm --model 4 --parity
                run python -m ddl_tpu_torch.bench.lm $lm --data 2 --model 2 --parity
                run python -m ddl_tpu_torch.bench.lm $lm --pipe 2 --seq 2 --attn ring \
                    --microbatches 4 --schedule 1f1b --parity ;;
            vit-tp)
                run python -m ddl_tpu_torch.bench.vit
                run python -m ddl_tpu_torch.bench.vit --data 2 --model 2 ;;
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
