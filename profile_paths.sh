#!/usr/bin/env bash
# Profiles the GRAND-nl and BLEND paths of chip_smoke.py on one CUDA card,
# one `python3 -m graph_neural_pde_tpu_torch.profile` run each (a warm-up
# epoch, then --epochs 3), in this order:
#   (v) GRAND-nl at bench.py's widths and precision (the bfloat16 payload
#       and rk4 state) over ogbn-arxiv-synthetic, softmax over rows;
#   (a) (v) in float32; (q) (a) as BLEND at bench.py's BLEND widths (features 96,
#       positions 32) over its seeded N(0, 1) encoding of width 32;
#   (h) (a) over columns; (r) (q) over columns;
#   (n) GRAND-nl over the GDC-rewired Cora stand-in;
#   (s) BLEND GRAND-nl over the Cora stand-in rewired by pos_enc_knn (DW64);
#   (i) the tuned ogbn-arxiv row over its stand-in; (p) (i) with --beltrami
#       (its DW64 encoding by DeepWalk on the card).
#
#     bash profile_paths.sh [extra profile.py flags]
#
# Each run prints the card's name and power limit first and a JSON summary
# last. Data (the stand-ins, the encodings' cache) goes to a fresh temporary
# directory per run, removed at the end.
set -euo pipefail
cd "$(dirname "$0")"
P="python3 -m graph_neural_pde_tpu_torch.profile --epochs 3 $*"
BENCH="--dataset ogbn-arxiv-synthetic"
ARXIV="$BENCH --rhs_payload_dtype float32 --dtype float32"
BLEND="--beltrami --attention_type exp_kernel --feat_hidden_dim 96
       --pos_enc_hidden_dim 32 --pos_enc_type DW32 --gaussian_pos_enc 7"
NL="--dataset Cora --function transformer --block constant
    --attention_norm_idx 0 --no-square_plus"
run() {
    echo "=== profile $1"
    shift
    $P "$@"
}
run "(v)" $BENCH
run "(a)" $ARXIV
run "(q)" $ARXIV $BLEND
run "(h)" $ARXIV --attention_norm_idx 1
run "(r)" $ARXIV --attention_norm_idx 1 $BLEND
run "(n)" $NL --rewiring gdc
run "(s)" $NL --beltrami --attention_type exp_kernel --pos_enc_type DW64 \
    --rewiring pos_enc_knn
run "(i)" --dataset ogbn-arxiv
run "(p)" --dataset ogbn-arxiv --beltrami
