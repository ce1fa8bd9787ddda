#!/bin/bash
# 30-epoch MCCL runs of the port on a CUDA card at the given seeds (7 and 13
# by default), with the recipe of the JAX package's plain-MCCL seed runs
# (tools/r4_ext.sh, part D: lr 2e-3, Adam, gap 0.5, warmup 10 of 30 epochs),
# so their best val Dice reads beside examples/README.md's mccl_s7 and
# mccl_s13. Each run's log.jsonl and summary.json are copied to
# OUT_DIR/mccl_s<seed>/; the checkpoints stay under runs/mccl_seeds/.
#
#   bash tools/mccl_seeds.sh OUT_DIR [SEED ...]
set -eu
out_dir=$1
shift
[ $# -gt 0 ] || set -- 7 13
for S in "$@"; do
  run=runs/mccl_seeds/s$S
  mkdir -p runs/mccl_seeds
  rm -rf "$run"
  python3 -m slcl_torch.train method=mccl data.dataset=synthetic data.gap=0.5 \
    optim.optimizer=adam optim.lr=2e-3 optim.epochs=30 contrastive.warmup_epochs=10 \
    run.eval_frequency=1 run.seed="$S" data.seed="$S" run.out_dir="$run" > "$run.out"
  mkdir -p "$out_dir/mccl_s$S"
  cp "$run"/*/log.jsonl "$run"/*/summary.json "$out_dir/mccl_s$S/"
  tail -n 1 "$run.out" | python3 -c "import json, sys; r = json.load(sys.stdin); print('mccl seed $S: best val dice', r['best_val_dice'], 'epoch', r['best_epoch'])"
done
