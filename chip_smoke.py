#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass (any failure exits nonzero):

1. environment: the card's name and power limit (nvidia-smi) and torch's
   device name; exits 2 without a CUDA device;
2. build: compiles the port's CUDA kernels from ``graph_neural_pde_tpu_torch/
   csrc`` (nvcc, sm_90a) and prints the build time;
3. kernels against their plain PyTorch versions, on the card, at max error
   <= 1e-5 of the largest reference entry (float32; the sums only run in
   another order). First the two dense products every fused kernel runs
   (``kernels.dense``, ``csrc/dense.cuh``), against their plain versions
   evaluated in float64 on the same inputs: the node projections
   ``node_project`` (both tables) in the three TABLES modes (float32; a
   float32 x beside the bfloat16 column table; both bfloat16), the
   bfloat16 k table bit for bit, at arxiv scale (169,343 nodes) at (a)'s
   widths D=128, ATT=32 and at BLEND's ATT=2 x 32, and at Cora's 2,708
   nodes at D=80, ATT=128 and kNN Cora BLEND's D=64+32, ATT=2 x 128
   (beside two ``torch.addmm`` calls); the dKw / dKb reduction
   ``outer_reduce`` over the nodes at the same widths (a bfloat16 table
   too at arxiv scale; beside ``torch.mm(x.T, dk)`` and ``dk.sum(0)``),
   over the bench oracle's payload rows (K8's per-head form) and, with
   the directed graphs below, over the arxiv-scale directed graph's slots
   gathered through its column index (K8 with dxg's form); two launches
   of each bit-identical. K1 ``csr_spmm`` forward, K1 as the backward ``dx``
   (weights permuted to the reverse edges, against A^T ct by index_add over
   columns) and K2 ``edge_dot`` as ``dw``, at two shapes: the prepared Cora
   stand-in at D=80 and an arxiv-scale symmetric random graph (169,343
   nodes, ~2.3M directed edges plus self-loops) at D=128; K1 (node state
   and every table mode) and K2 everywhere against their plain versions
   evaluated in float64 on the same inputs, a line before each check
   printing the lane group and vector width ``kernels.lanes`` picks (and
   K1's walk, from the mean row length), K1 in table mode also as K11's dx
   (``column_head_sum``, timed on the Cora stand-in at H=8 and at arxiv
   scale at H=2). A kernel timed beside a library call is timed with it in
   alternating profiler sessions (``LIBRARY_SESSIONS`` each, the library
   call's device kernels named once per shape), and after the kernel
   checks one line names every timed shape at which K1, K2, K3, K4, K10,
   K11, K15, K16, the node projections or the dKw reduction is slower than
   its library call by the sessions' medians (``torch.sparse.mm``,
   ``sampled_addmm``, ``torch.sparse.softmax`` and its backward,
   ``torch.addmm``, ``torch.mm``; slow does not fail, wrong does), and one
   for every timed shape at which K7 or K8 with dxg is slower than its
   plain version. K3 ``segment_norm`` (softmax and normalise, over rows and
   over columns through the reverse-edge map) and K4 ``segment_norm_bwd``
   (both modes, rows and columns), on the prepared Cora stand-in at the
   tuned row's H=8 (the main path's shape; first, so that the closing line
   reads it), the same with a hub row of degree 360 (cora-hub), the
   Computers stand-in at H=4 and the arxiv-scale graph at H=1 and H=8, a
   line before each naming ``segment_design``'s lane group and vector width
   and the segments' pieces; two launches of K3 and of K4 on the same input
   must be bit-identical, and neither may put a memset (or any device
   operation but their own kernels) on the card. K6 ``fused_rhs_fwd`` (plain with its numerators, with
   per-edge shifts, folded), K7 ``fused_rowmax``, K8 ``fused_rhs_bwd`` and
   K9 ``fused_rhs_bwd_sym`` (every output; K8 and K9 against the plain
   version evaluated in float64 on the same float32 inputs, so that the
   bound holds the kernel's rounding and not the reference's), for all five
   score families (BLEND's exp_kernel_beltrami over block-structured packed
   projections, as ``models.functions.pack_beltrami`` builds them, with its
   two pairs of scalars) on the Cora stand-in at D=16, ATT=16, H=4, for
   scaled_dot at the two real shapes: the Cora stand-in at D=80, ATT=128,
   H=8 and the arxiv-scale graph at D=128, ATT=32, H=2, and for
   exp_kernel_beltrami at bench.py's BLEND widths on the arxiv-scale graph
   (D=128, packed ATT=2 x 32, H=2); two K9 launches must be
   bit-identical; K6-K9 and K12-K14 also over the Cora stand-in with a
   hub row of degree 360 at D=80, ATT=128, H=8, whose row K6, K7, K8 (with
   and without dxg), K9 and K12-K14 cut into pieces that a second pass
   merges (there and on the kNN graph below the row pieces must include
   rows of several). Before each check of K6-K9 and K12-K14 a line prints
   the walk's design (``kernels.fused_rhs.fwd_design``, ``sym_design``,
   ``rowmax_design`` and ``dxg_design``: its register tiles, how a head
   is summed, K6's heads in registers, K7's edges a batch, the tile of K8's
   dxg pass on the tensor cores) and the graph's row pieces. On graphs
   whose rows hold one edge each (the Cora stand-in
   at D=80, ATT=128, H=8 and 20,000 nodes at D=128, ATT=32, H=2), float32
   and on the bfloat16 column table, K6 shifted by K7's row maxima with
   gmax = 0 must give den exactly 1.0 in every row and head: K7 scores
   each edge as K6 does, bit for bit.
   K10 ``dual_scatter`` and K11 ``dual_gather`` (K11
   also against its plain version in float64), at a small shape (D=16,
   H=4), the Cora stand-in at D=80, H=8 (also over the hub row of degree
   360, which both cut into row pieces) and the arxiv-scale graph at
   D=128, H=2, with a float32 table and with the bfloat16 column table (the
   composed RHS's bf16 payload; timed beside float32 in the same run), the
   float32 ones timed beside their library calls (K10: ``torch.sparse.mm``
   of the [N*H, N] CSR by [x | 1]; K11: ``sampled_addmm`` for du plus
   ``torch.sparse.mm`` of the transposed CSR for dx, each printed); two
   launches of each must be bit-identical. K12 ``norm1_den`` (the column
   denominators, and the same sum weighted by the cotangent), K13
   ``norm1_fwd`` and K14 ``norm1_bwd`` (every output, against the plain
   version in float64), for all five score families on the Cora stand-in
   at D=16, ATT=16, H=4, for scaled_dot at the same two real shapes and
   for exp_kernel_beltrami at the arxiv-scale BLEND widths; two launches
   of each must be bit-identical. K15 ``blocked_spmm``
   (forward, and dx on the transposed plan) and K16 ``blocked_sddmm`` over
   the block plan (1024-node blocks, 1024-slot chunks) of: the Cora
   stand-in after rcm at D=80, the ogbn-arxiv stand-in after rcm at D=162,
   the image CLI's batches (64 MNIST-shaped 28 x 28 grids, D=1; 64
   CIFAR-shaped 32 x 32 grids with diagonals, D=3) and an 8-neighbour
   412 x 411 grid (ogbn-arxiv's node count) at D=128, each with K1 and K2
   on the same row-sorted graph beside it (the library calls: the forward
   and dx by ``torch.sparse.mm`` on the CSR and on its transpose); two
   launches of each must be bit-identical. On directed graphs (no
   reverse-edge map): K17 ``fused_rhs_bwd_col`` (x[col]'s cotangent walked
   over the CSC view's column pieces, and dKw, dKb from each column's
   summed dk; the pieces' count and the longest column printed, and the
   time beside that of pieces of 64 edges) and K8 without its per-edge dxg
   (dq, dgmax), against their plain versions in float64,
   for all five score families on a small random directed graph (2,000
   nodes, pieces of 4 edges, so that most columns take K17's second pass)
   at D=16, ATT=16, H=4 and for scaled_dot on the Cora stand-in
   rewired by GDC on the card (the CLI's defaults) at D=80, ATT=128, H=8
   and on ogbn-arxiv-synthetic's random pairs one way only (169,343 nodes,
   plus self-loops) at D=128, ATT=32, H=2 (and exp_kernel_beltrami at
   packed ATT=2 x 32), two K17 launches bit-identical; at (s)'s shape, the
   Cora stand-in rewired by ``pos_enc_knn`` (DW64 by DeepWalk on the card;
   hub columns), exp_kernel_beltrami at D=64+32, packed ATT=2 x 128, H=8:
   K6, K8 (two launches bit-identical), K8 without dxg and K17;
   K1 as the column sum dx = A^T ct over the CSC view, K3/K4 over its
   columns, against ``index_add`` over the columns, and K10 with K11's du
   and its dx by K1 over the CSC view, on those two graphs (timed beside
   their plain versions and library calls). Over a random per-edge
   payload x_g [E, D] (the bench oracle's operand): K18
   ``fused_aggregate`` (and with per-edge shifts), K19 ``fused_score_max``
   (scaled_dot) and K8's per-head mode ``fused_rhs_bwd_heads`` (every
   output, against the plain version in float64), for all five score
   families on the Cora stand-in at D=16, ATT=16, H=4, for scaled_dot at
   the bench oracle's shape (N=512, E=4096, D=128, ATT=64, H=2) and on the
   arxiv-scale graph at D=128, ATT=32, H=2, and for exp_kernel_beltrami at
   the packed BLEND widths there (D=128, ATT=2 x 32, H=2); two launches of
   each bit-identical; and the same over a bfloat16 payload beside a
   float32 and a bfloat16 row side (the payload's bf16 mode: the plain
   versions widen the rows, k_e unrounded): all five families small
   (untimed), the bench oracle's shape, the Cora stand-in and the same
   with a hub row at D=80, ATT=128, H=8, the arxiv-scale graph at D=128,
   ATT=32, H=2 and at the BLEND widths (timed); K19 walks the graph's
   row pieces as K18 does, and K18 of the four key families is timed at
   the Cora GRAND-nl widths over the hub row (D=80, ATT=128, H=8),
   float32 and bfloat16 payloads. The P6 pair on every rank of a 4-way
   split of the row-sorted valid edges (``make_sharded_stripe_spmm``'s
   shards: rows
   straddle ranks, most of a rank's row pointers are empty ranges) of the
   arxiv-scale graph at D=128, on ranks 0 and 3 of one of the Cora
   stand-in and on the whole Cora stand-in as one rank's shard at D=80:
   K1 ``csr_spmm`` in table mode (the scatter of a per-edge payload;
   yardstick ``torch.segment_reduce``) and K20 ``row_gather`` (its gather;
   yardstick ``index_select``), two launches of each bit-identical; and,
   on ranks 0 and 3 of the arxiv split and the whole Cora stand-in, the
   stripe spmm's bfloat16 payload: K1 in table mode on a bfloat16 payload
   and K20 writing bfloat16 rows (yardstick ``index_select`` and the
   cast). The
   all-reduce schedules' edge shards at path (u)'s widths: K1 forward, K18,
   K19 and K8's per-head mode on the Cora stand-in as one rank's shard
   (D=80, ATT=128, H=8; K1's dx over the shard's CSC view too) and on each
   rank of a 4-way split at arxiv scale (D=128, ATT=32, H=2), in float32
   and under the bf16 ODE state (x and the payload bfloat16). K21
   ``smem_gather`` over probe 13's 2,703,360 indices from tables [T, 128]
   in shared memory, float32 T = 8, 64, 448 and bfloat16 T = 512, bit for
   bit against ``index_select``, and its refusal of a float32 table of 512
   rows (256 KB). The bfloat16 payload (the JAX package's
   ``rhs_payload_dtype="bfloat16"``): K1 forward, K1 as dx and K2 as dw on
   bfloat16 tables (x, and for dx the cotangent, cast to bfloat16) on the
   Cora stand-in at D=80 and the arxiv-scale graph at D=128; K6 (with its
   numerators, with the exact mode's shifts, folded), K7, K8 and K9 on the
   bfloat16 column table at the Cora GRAND-nl widths (D=80, ATT=128, H=8),
   at the arxiv scale (D=128, ATT=32, H=2) with the row side bfloat16 too
   (the bench's bf16 state; untimed with a float32 row side), and,
   untimed, for all five families at D=16, ATT=16, H=4; on directed
   graphs K6 (shifted too), K7, K8 and the column-plan backward (K8
   without dxg, K17) on the bfloat16 column table: the GDC-rewired Cora
   stand-in at D=80, ATT=128, H=8, the directed arxiv-scale graph at
   D=128, ATT=32, H=2 with both row sides (the bf16 one timed), the
   ``pos_enc_knn`` Cora graph at BLEND's (s) widths (K8 without dxg, K17)
   and, untimed, all five families on the small random directed graph;
   K12 (both modes), K13 and K14 on the bfloat16 column table at the Cora
   GRAND-nl widths (a float32 row side timed, a bfloat16 one untimed), at
   the arxiv scale (D=128, ATT=32, H=2) and the arxiv BLEND widths (packed
   ATT=2 x 32) with the bench's bf16 row side (timed) and a float32 one
   (untimed), and all five families small (untimed); each against its
   plain version on the same tables (K8's, K9's, K14's and K17's in
   float64 beside the bfloat16 table), two launches bit-identical.
   Each check is timed: device time per call (torch.profiler after
   warm-up calls in the same session, mean of 10 calls; the device events
   of each call are counted by the launch they come from, and a session
   whose calls differ lost events: it is measured again, three sessions in
   all, or the check fails; all device work of the call, so the wrapper's
   output memset counts) and time per call seen from the host
   (CUDA events around one call, median of 10; at small shapes this is the
   host's launch cost). Beside each time stands the least time the card
   could take for the same work (``bound``: the larger of the compulsory
   bytes over 3.35 TB/s and the float32 operations over 67 TFLOP/s, from
   this run's shapes; exp_kernel_beltrami's packed projections counted
   over their non-zero blocks, its per-edge terms at the packed width)
   and, where one PyTorch call computes the same
   function, that call's time (``library``);
4. end to end on small inputs, card against CPU (the plain versions, which
   the CPU test suite holds against the JAX package), from the same
   weights: tuned Cora at reduced width (one training forward and backward,
   and the early-stop eval), and tuned Computers at reduced width (hard
   attention and the continuous adjoint with its dopri5 backward solve),
   and the Cora GRAND-nl config (transformer function) at reduced width
   with the softmax, with the row's squareplus, as the GAT function, and
   with the softmax over columns (the row's own ``attention_norm_idx``),
   the tuned Cora row on the blocked engine (128-node blocks), the
   image model (one training forward and backward) on both engines, and
   the tuned Cora row and Cora GRAND-nl (the softmax, squareplus, the GAT
   function) over one GDC-rewired (directed) edge list, built once on the
   card and handed to both devices; the tuned Cora row and Cora GRAND-nl
   with the bfloat16 payload, and Cora GRAND-nl with ``sym_backward=False``
   (the column-plan backward) and with the softmax over columns (K12-K14),
   each with the payload and at bench.py's precision (the bf16 state too),
   and Cora GRAND-nl with squareplus and as the GAT function the same way
   (K10/K11 on the bfloat16 column table), all on rk4 (logits within 3e-4 of
   their scale under the payload, within one bf16 step, 2^-8, of theirs
   and of each gradient leaf's under the bf16 state); BLEND (a seeded positional encoding,
   the dual encoder at widths 12 + 4, the split-space score): Cora GRAND-nl
   over rows and over columns, the tuned Cora row's attention block, the
   tuned ogbn-arxiv row's dual encoder; DeepWalk's skip-gram training
   card against CPU from one start, the ``pos_enc_knn`` rewiring of the
   300-node SBM from a DeepWalk encoding computed on the card (card and
   CPU kNN agree), and Cora BLEND GRAND-nl over that directed graph; the
   tuned Cora row's attention block solved with the stripe spmm (the P6
   pair per rank) and the all-reduce spmm over an in-process 4-way split
   (``parallel.split_mesh``), card against CPU and against the unsharded
   block. Where the logits of a check disagree, it reruns both sides and
   a float64 CPU run from the same weights and prints each one's distance
   from the others before it fails. Each check records its first forward
   on each device (``ForwardRecorder``: the encoder's output, every call
   of the frozen attention's CPU ops with its inputs and outputs, the
   frozen attention, every solver stage's time, state and output, the
   prepared graph's views); where the logits disagree it records the CPU
   model object's forward again, prints where that and the card's first
   forward part from the CPU's first (``compare_forwards``: the first
   attention op whose call differs among them) and saves the three under
   ``chiprun_out/`` of the working directory;
5. main paths, each through ``graph_neural_pde_tpu_torch.run`` at full
   width, every kernel launch counter reset just before each run and read
   just after (the bfloat16 launches of K1, K2, K6, K7, K8, K9, K12, K13,
   K14, K17, K18, K19 and K8's per-head mode, and K6's shifted ones,
   counted apart among their own):
   tuned Cora for
   1 training epoch (followed by an eval step
   and the early-stop eval) twice, to record whether two runs agree bit
   for bit; tuned Computers (hard attention, continuous adjoint) and tuned
   Pubmed (row squareplus attention, continuous adjoint) for 1 epoch each;
   (a) the GRAND-nl architecture of ``bench.py`` in float32 on the random
   graph at ogbn-arxiv's size for 1 epoch with eval; (b) the tuned Cora
   row as GRAND-nl with the row softmax (transformer function, constant
   block) for 1 epoch with the early-stop eval; (c) the same model with Q
   and K drawn so large that the unshifted softmax overflows, which must
   poison, re-solve with the exact softmax and stay finite; (d) the tuned
   Cora row as GRAND-nl as tuned, with squareplus attention, for 1 epoch;
   (e) the same row with the GAT function for 1 epoch; (f) (a)'s
   architecture with squareplus attention for 1 epoch, printing the peak
   device memory; (g) the tuned Cora row as GRAND-nl with the softmax
   normalised over columns, as the row's ``attention_norm_idx=1`` says
   (K12-K14), for 1 epoch with the early-stop eval, and its forced poison,
   which must re-solve on the composed exact softmax; (h) (a)'s
   architecture with ``attention_norm_idx=1`` for 1 epoch; (i) the tuned
   ogbn-arxiv row (hard attention, batch norm, rk4 adjoint, rmsprop) over
   its stand-in for 1 epoch, as tuned and with ``use_labels``; (j) the
   tuned Cora row with ``spmm_impl="pallas_blocked", node_reorder="rcm"``
   for 1 epoch with the early-stop eval, which must launch K15 and K16 and
   neither K1 nor K2; (k) ``train_image`` on the blocked engine at the
   image CLI's defaults (batch 64, rk4, step 1, T = 3) over the stand-in
   images for four batches, without and with ``remat`` (identical losses;
   the peak device memory of each is printed); (l) the same on the
   default engine (K1), whose loss must agree with (k)'s; (m) the tuned
   Cora row with ``rewiring="gdc"`` at the CLI's defaults (approximate
   PPR, top 64 per column) for 1 epoch with the early-stop eval, a
   directed graph whose column-side passes (K1's dx, K3/K4) walk its CSC
   view; (n) (b) over the same GDC graph, which must launch K6, K8 and K17
   and not K9; (o) (a) with ``sym_backward=False``, the JAX package's
   column-plan backward (K8 without dxg, K17, never K9), its epoch time
   printed beside (a)'s; (p) the tuned ogbn-arxiv row with ``beltrami``
   (its DW64 encoding computed by DeepWalk on the card; GRAND-l with the
   dual encoder at widths 64 + 98); (q) BLEND GRAND-nl at bench.py's
   BLEND widths (feature 96, positions 32, split-space score) over
   ogbn-arxiv-synthetic with bench.py's seeded N(0, 1) encoding of width
   32 (read from the encodings' cache), K6 and K9; (r) (q) with the
   softmax over columns, K12-K14; (s) (b) with BLEND over the Cora
   stand-in rewired by ``pos_enc_knn`` from its DW64 encoding (computed on
   the card in phase 3 and read from the cache), a directed graph: K6, K8
   and K17, never K9; (t) the bench entry, ``graph_neural_pde_tpu_torch.
   bench.main`` at full width: its oracles on the card (K18 with K19's
   shift and K8's per-head mode among the kernels they hold, over the
   bfloat16 payload as the JAX bench's oracle runs them), then its
   forward, train-step and secondary timings at bench.py's precision (the
   bfloat16 payload and rk4 state: K1, K2, K6, K9 and K12-K14 on bfloat16
   tables),
   printing its JSON line; (v) ``config.GRAND_NL_BENCH`` at bench.py's
   precision over ogbn-arxiv-synthetic at full width: the folded forward,
   its logits against the float32 model's from the same weights, then 3
   training steps under remat and 3 under the rk4 adjoint, each step's ms
   printed (K6 and K9 on the bfloat16 column table); (w) (v) with
   ``sym_backward=False``: 3 remat steps, each step's ms printed, K6, K8
   and K17 on the bfloat16 column table, never K9; (x) the forced poison
   at bench.py's precision (the bf16 payload and rk4 state) on Cora
   GRAND-nl and on ``GRAND_NL_BENCH`` at arxiv scale, 1 epoch each, which
   must re-solve on the bfloat16 column table (K7, K6 shifted, K8 with
   dxg) and stay finite, loss and gradients; (y) (v) with the softmax
   over columns: 3 remat steps, each step's ms printed, K12-K14 on the
   bfloat16 column table; (z) the forced poison over columns at bench.py's
   precision on Cora GRAND-nl at T = 2, which must poison in K12/K13 on the
   bfloat16 column table, re-solve on the composed exact softmax over
   columns (K3/K4, K1/K2 on the bf16 state) and stay finite; (A) (f) at
   bench.py's precision: 3 remat steps, each step's ms printed beside (f)'s
   float32 epoch, K10/K11 on the bfloat16 column table; (B) (e) at
   bench.py's precision for 1 epoch (s_dst and K10/K11 on the bfloat16
   table), and the exp_kernel family's forced poison at that precision at
   T = 2 (output_var 20: every score near 400), which must poison in K6 on
   the bfloat16 table, re-solve on the composed exact softmax (K3/K4,
   K10/K11 on the bf16 table) and stay finite; (C), inside (u), the stripe
   spmm under the bfloat16 payload: the Cora block on rk4 over the one
   NCCL rank against the block on the payload's semantics in torch ops
   (its gap to ``make_spmm``'s payload printed), and the arxiv split's
   rank bodies and their dx against K1 unsharded; (u)
   the multi-device layer (``graph_neural_pde_tpu_torch.parallel``): first
   a world of two NCCL ranks on card 0, in a process of its own, which
   must end in NCCL's refusal of two ranks on one GPU, then over a world of
   one NCCL rank the tuned Cora row's attention block at full width (hidden
   80, squareplus over columns, dopri5) solved with ``spmm_fn`` from
   ``make_sharded_stripe_spmm`` and from ``make_sharded_spmm_for`` in both
   modes, each against the same block on the default engine (NFE, z,
   every gradient), and the attention RHS through
   ``make_sharded_fused_rhs_for`` in both modes (K18 per rank) against K6,
   then both dispatchers in both modes under the bf16 ODE state (K1, K18
   and K8's per-head mode on the bfloat16 x and payload) against
   ``make_spmm`` on the bf16 x and K6 on x widened; the per-rank bodies of
   a 4-way split at arxiv scale run rank by rank in this process, their
   partials summed in rank order (the stripe spmm and its dx, the
   all-reduce spmm and the attention RHS at (a)'s widths, float32 and
   under the bf16 state, against K1 and K6 unsharded); and the gather
   probes
   (``graph_neural_pde_tpu_torch.probes.gather``), which print their lines
   and the gather's time at arxiv scale beside K6, K9, K13 and K14. Each
   run must launch the kernels its path runs, and all twenty-two counters
   (K8 with and without dxg apart), and the nineteen of the bfloat16
   launches (K1, K2, K6, K6 shifted, K7, K8 with and without dxg, K9,
   K10, K11, K12, K13, K14, K17, K18, K19, K8's per-head mode, K20 and K1
   in table mode), must grow, and so must those of the node projections
   and the dKw reduction, which every fused kernel's launch runs (on (a),
   (q), (r), (s) and (v) each); no run may have built row pieces on the fly
   (the walks of K6, K8 without dxg, K9 and K12-K14 take the graph's own
   ``Graph.row_pieces``: their ``piece_builds`` stay 0). The paths
   (a)-(s) run ``GRAND_NL_BENCH``'s architecture in float32, as before the
   bfloat16 mode.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REL_BOUND = 1e-5
SCORE_FAMILIES = ("scaled_dot", "cosine_sim", "pearson", "exp_kernel",
                  "exp_kernel_beltrami")
BELTRAMI = "exp_kernel_beltrami"


DEVICE_MS_TAG = "device_ms call"
WARM_UP_TAG = "device_ms warm-up"


def _session_events(fn, reps: int, warm_up_s: float = 0.025):
    """One torch.profiler session of ``fn``: warm-up calls for at least
    ``warm_up_s`` seconds in an annotated range (the profiler loses device
    events in the first moments of a session), then ``reps`` calls, each
    between two synchronisations in an annotated range of its own. Returns
    the session's raw events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WARM_UP_TAG):
            t0, calls = time.perf_counter(), 0
            while calls < 3 or time.perf_counter() - t0 < warm_up_s:
                fn()
                torch.cuda.synchronize()
                calls += 1
        for i in range(reps):
            with record_function(f"{DEVICE_MS_TAG} {i}"):
                fn()
                torch.cuda.synchronize()
    return prof.profiler.kineto_results.events()


def _per_call_device_events(events, reps: int):
    """(device events per counted call, device events of the counted calls,
    their summed duration in us, device events whose launch was not found)
    of a ``_session_events`` session. A device event belongs to the range
    that holds the host-side runtime call (``cuda*`` / ``cu*``) that
    launched it, matched by the CUPTI correlation id, so that host and
    device clocks need not agree."""
    import bisect
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    spans = sorted((e.start_ns(), e.end_ns()) for e in host
                   if e.name().startswith(DEVICE_MS_TAG))
    warm = [(e.start_ns(), e.end_ns()) for e in host
            if e.name() == WARM_UP_TAG]
    launched = {e.correlation_id(): e.start_ns() for e in host
                if e.name().startswith("cu") and e.correlation_id() > 0}
    starts = [a for a, _ in spans]
    counts, n_dev, total, orphans = [0] * reps, 0, 0.0, 0
    for e in events:
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.name().startswith(("device_ms", "ProfilerStep"))):
            continue
        t = launched.get(e.correlation_id())
        if t is None:
            orphans += 1
            continue
        if any(a <= t <= b for a, b in warm):
            continue
        n_dev += 1
        total += e.duration_ns() / 1e3
        i = bisect.bisect_right(starts, t) - 1
        if len(spans) == reps and 0 <= i and t <= spans[i][1]:
            counts[i] += 1
    return counts, n_dev, total, orphans


def device_ms(fn, reps: int = 20, attempts: int = 3):
    """Mean device time of one call of ``fn``: the summed duration of the
    device events (kernels, memsets, copies) it puts on the card, from one
    torch.profiler session over ``reps`` calls after a warm-up. Every call
    puts the same work on the card, so the events are counted call by call
    and the counts must agree: a session in which they differ, or in which
    a device event belongs to no call, lost events and would read too
    fast. It is measured again, ``attempts`` sessions in all, and then
    raises rather than print a time. None when no session records any
    device activity."""
    import torch
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        counts, n_dev, total, orphans = _per_call_device_events(
            _session_events(fn, reps), reps)
        if (len(set(counts)) == 1 and counts[0] > 0
                and sum(counts) == n_dev and not orphans):
            return total / reps / 1e3
        seen.append((counts, n_dev, orphans))
    if not any(n_dev or orphans for _, n_dev, orphans in seen):
        return None
    raise AssertionError(
        f"device_ms: device events per call (then in all, then without a "
        f"launch) differ in each of {attempts} profiler sessions {seen}: "
        f"the profiler lost events, so no time is read")


def prepared_graph(row: str, data_dir: str, **overrides):
    """The tuned row's dataset (its SBM stand-in without raw files), with
    ``overrides`` (e.g. ``node_reorder``) on its config, prepared as its
    block prepares it."""
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.datasets import get_dataset
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    cfg = best_params[row].replace(**overrides)
    d = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc)
    return prepare_graph(cfg, d.graph)


def image_config(**overrides):
    """The image CLI's configuration (``training/run_image.py``)."""
    from graph_neural_pde_tpu_torch.config import Config
    return Config(block="constant", function="laplacian", method="rk4",
                  step_size=1.0, time=3.0, input_dropout=0.0, dropout=0.0,
                  lr=0.01, decay=0.0, self_loop_weight=1.0).replace(
                      **overrides)


def grid_graph(batch: int, h: int, w: int, diagonals: bool):
    """``batch`` h x w pixel grids as one graph, prepared as the image
    model prepares it (self-loops, random-walk norm, row sort)."""
    from graph_neural_pde_tpu_torch.data.image import batched_grid_graph
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    return prepare_graph(image_config(),
                         batched_grid_graph(batch, h, w, diagonals))


def directed_random_graph(n: int, pairs: int, seed: int):
    """``pairs`` uniform pairs over ``n`` nodes drawn from ``seed`` as
    ogbn-arxiv-synthetic draws its own (at its size, with its seed, its
    pairs), one way only, prepared as the attention block prepares its
    graph (random-walk norm, self loops): a directed graph, whose
    column-side passes walk its CSC view."""
    import numpy as np
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    from graph_neural_pde_tpu_torch.ops.graph import make_graph
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, size=pairs, dtype=np.int64)
    col = rng.integers(0, n, size=pairs, dtype=np.int64)
    g = make_graph(row.astype(np.int32), col.astype(np.int32), num_nodes=n,
                   pad_multiple=512)
    return prepare_graph(best_params["Cora"], g)


def hub_graph(g, degree: int, seed: int):
    """``g``'s valid edges with node 0 joined both ways to ``degree`` other
    nodes drawn from ``seed``: a symmetric graph whose row 0 is a hub far
    longer than the row pieces K9 and K14 cut (``Graph.col_pieces``)."""
    import numpy as np
    from graph_neural_pde_tpu_torch.ops.graph import make_graph
    nv = g.num_valid
    row, col = g.row[:nv].cpu().numpy(), g.col[:nv].cpu().numpy()
    rng = np.random.default_rng(seed)
    peers = rng.choice(np.arange(1, g.num_nodes), degree, replace=False)
    hub = np.zeros(degree, row.dtype)
    return make_graph(np.concatenate([row, hub, peers]),
                      np.concatenate([col, peers, hub]),
                      num_nodes=g.num_nodes, pad_multiple=512).sort_by_row()


def gdc_graph(cfg, data_dir: str):
    """``cfg``'s dataset (its stand-in without raw files) rewired by GDC,
    the dense diffusion on the card, and prepared as its block prepares
    it."""
    from graph_neural_pde_tpu_torch.data.datasets import get_dataset
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    d = get_dataset(cfg, data_dir, use_lcc=cfg.not_lcc, device="cuda")
    return prepare_graph(cfg, d.graph)


def plain64(fn, *args):
    """A plain version evaluated in float64 on the same inputs (a bfloat16
    table widened exactly), its output back in float32: the reference the
    K1 and K2 checks hold the kernels to."""
    import torch

    def up(t):
        return (t.double() if torch.is_tensor(t) and t.is_floating_point()
                else t)
    return lambda: fn(*map(up, args)).float()


def print_lanes(kname, shape_name, d, *tables, mean_row=None):
    """The lane group and vector width the wrapper of K1 (``csr_spmm``),
    K2 (``edge_dot``) or K16 (``blocked_sddmm``, K2's) picks for these
    tables (``kernels.lanes``), and K1's staging depth for rows of
    ``mean_row`` edges on average (``csr_design``)."""
    from graph_neural_pde_tpu_torch.kernels.lanes import csr_design, lanes
    stage = ""
    if kname == "csr_spmm":
        group, vec, s = csr_design(d, mean_row, *tables)
        stage = f" S={s} (mean row {mean_row:.2f} edges)"
    else:
        group, vec = lanes("edge_dot" if kname == "blocked_sddmm" else kname,
                           d, *tables)
    name = "G" if kname == "csr_spmm" else "L"
    print(f"[lanes] {kname} @ {shape_name} row width {d} "
          f"({', '.join(str(t.dtype).split('.')[1] for t in tables)}): "
          f"{name}={group} V={vec}{stage}", flush=True)


def check_kernels(shape_name, g, d, seed, dev="cuda", table=None):
    """K1 forward, K1 as dx, K2 as dw against their plain versions; two
    launches of each bit-identical. ``table=torch.bfloat16`` (the JAX
    package's bf16 payload): x and, for dx, the cotangent are bfloat16
    tables beside float32 weights, sums and outputs, and the plain versions
    read the same tables. No single PyTorch call computes a float32-weighted
    sum of bfloat16 rows in float32, so that mode times no library call."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import (csr_spmm, csr_spmm_plain,
                                                    edge_dot, edge_dot_plain)
    dev = torch.device(dev)
    table = table or torch.float32
    tag = "" if table == torch.float32 else " bf16"
    g = g.to(dev)
    n, nv = g.num_nodes, g.num_valid
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev).to(table)
    ct = torch.randn((n, d), generator=gen, device=dev)
    ct_t = ct.to(table)
    # asymmetric positive weights on valid slots, as the frozen attention
    w = torch.rand((g.capacity,), generator=gen, device=dev) * g.mask
    w_rev = w[g.rev.long()]
    row_l, col_l = g.row.long()[:nv], g.col.long()[:nv]

    def dx_plain(wide=False):
        f = torch.float64 if wide else torch.float32
        return torch.zeros_like(ct, dtype=f).index_add(
            0, col_l, ct_t[row_l].to(f) * w[:nv, None].to(f)).float()

    # the yardsticks: one PyTorch call each, used nowhere in the port
    library = (None, None)
    if not tag:
        csr = torch.sparse_csr_tensor(g.rowptr, g.col[:nv], w[:nv],
                                      size=(n, n))
        pattern = torch.sparse_csr_tensor(g.rowptr, g.col[:nv],
                                          torch.zeros_like(w[:nv]),
                                          size=(n, n))
        x_t = x.t().contiguous()
        library = (lambda: csr @ x,
                   lambda: torch.sparse.sampled_addmm(pattern, ct, x_t,
                                                      beta=0.0))
    # K1 reads rowptr, col, w and its table and writes out; K2 reads row,
    # col and both tables and writes one float per edge; 2 flop per edge and
    # feature
    esz = x.element_size()
    spmm_work = (4 * (n + 1 + 2 * nv + n * d) + esz * n * d, 2 * nv * d)
    dot_work = (4 * (3 * nv + n * d) + esz * n * d, 2 * nv * d)
    cases = (
        ("csr_spmm" + tag, "forward A_w x",
         lambda: csr_spmm(g.rowptr, g.row, g.col, w, x, n_edges=nv),
         lambda: csr_spmm_plain(g.rowptr, g.row, g.col, w, x), spmm_work,
         library[0], plain64(csr_spmm_plain, g.rowptr, g.row, g.col, w, x)),
        ("csr_spmm" + tag, "backward dx = A_w^T ct",
         lambda: csr_spmm(g.rowptr, g.row, g.col, w_rev, ct_t, n_edges=nv),
         dx_plain, spmm_work, None, lambda: dx_plain(wide=True)),
        ("edge_dot" + tag, "backward dw = ct[row].x[col]",
         lambda: edge_dot(g.row, g.col, ct, x, nv),
         lambda: edge_dot_plain(g.row, g.col, ct, x, nv), dot_work,
         library[1], plain64(edge_dot_plain, g.row, g.col, ct, x, nv)),
    )
    print_lanes("csr_spmm", shape_name, d, x, mean_row=nv / n)
    print_lanes("edge_dot", shape_name, d, ct, x)
    rows = []
    for kname, what, kern, plain, work, lib, ref in cases:
        rows.append(time_case(kname, what, shape_name,
                              f"N={n} E={nv} D={d}{tag}", kern, plain, work,
                              lib, reference=ref))
        if not torch.equal(kern(), kern()):
            raise AssertionError(f"{kname} {what} @ {shape_name}: two "
                                 f"launches differ")
    print(f"[kernels] csr_spmm / edge_dot{tag} @ {shape_name}: two launches "
          f"bit-identical", flush=True)
    return rows


def check_dense_kernels(shape_name, n, d, att, seed, modes=(0, 1, 2),
                        reduce_bf16=False, dev="cuda"):
    """The node projections (``kernels.dense.node_project``) in the TABLES
    ``modes`` (0 float32; 1 a float32 x beside the bfloat16 column table;
    2 both bfloat16) and the reduction ``outer_reduce`` over the N nodes
    (K9, K14, K17's form; also over a bfloat16 table with
    ``reduce_bf16``), each against its plain version evaluated in float64
    on the same inputs (1e-5 of scale), the bfloat16 k table bit for bit,
    two launches bit-identical. Library calls: two ``torch.addmm`` for the
    float32 tables, ``torch.mm(x.T, dk)`` and ``dk.sum(0)`` for the
    reduction over a float32 table."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.dense import (
        bf16_round, node_project, node_tables_plain, outer_reduce)
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x32 = torch.randn((n, d), generator=gen, device=dev)
    qw, kw = (torch.randn((d, att), generator=gen, device=dev) / math.sqrt(d)
              for _ in range(2))
    qb, kb = (0.1 * torch.randn((att,), generator=gen, device=dev)
              for _ in range(2))
    bf = torch.bfloat16
    rows = []
    for mode in modes:
        x = x32 if mode < 2 else x32.to(bf)
        xcol = None if mode == 0 else x32.to(bf)
        k_w, k_b = (kw, kb) if mode == 0 else (bf16_round(kw), bf16_round(kb))
        want = node_tables_plain(x.double(), xcol, qw.double(), qb.double(),
                                 k_w.double(), k_b.double())
        got = node_project(x, qw, qb, kw, kb, xcol=xcol)
        if mode and not torch.equal(got[1], want[1]):
            raise AssertionError(f"node_project @ {shape_name} mode {mode}: "
                                 "the bfloat16 k table differs from the "
                                 "plain version's bits")
        again = node_project(x, qw, qb, kw, kb, xcol=xcol)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"node_project @ {shape_name} mode {mode}: "
                                 "two launches differ")
        esz = x.element_size()
        work = (n * d * esz + (2 * n * d if mode == 1 else 0)
                + 2 * (d + 1) * att * 4
                + n * att * (8 if mode == 0 else 6), 4 * n * d * att)
        library = ((lambda: (torch.addmm(qb, x32, qw),
                             torch.addmm(kb, x32, kw))) if mode == 0
                   else None)
        tag = {0: "", 1: " f32 x, bf16 xcol", 2: " bf16"}[mode]
        rows.append(time_case(
            "node_project", f"q, k tables mode {mode}", shape_name,
            f"N={n} D={d} ATT={att}{tag}",
            lambda: node_project(x, qw, qb, kw, kb, xcol=xcol),
            lambda: node_tables_plain(x, xcol, qw, qb, k_w, k_b), work,
            library, reference=lambda: want))
    print(f"[kernels] node_project @ {shape_name}: modes {modes} within "
          f"{REL_BOUND:g} of scale, the bf16 k table bit for bit, two "
          "launches bit-identical", flush=True)
    dk = torch.randn((n, att), generator=gen, device=dev)
    for table in (torch.float32,) + ((bf,) if reduce_bf16 else ()):
        x = x32.to(table)
        tag = "" if table == torch.float32 else " bf16 x"
        rows.append(check_outer_reduce(shape_name, x, None, dk, tag))
    return rows


def check_outer_reduce(shape_name, x, idx, dk, tag="", timed=True):
    """``outer_reduce`` over dk's rows of x (gathered through ``idx``, or
    x's rows) against its plain version in float64 (1e-5 of scale); two
    launches bit-identical. The library call (float32 x, not gathered):
    ``torch.mm(x.T, dk)`` and ``dk.sum(0)``."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.dense import (
        outer_reduce, outer_reduce_plain, reduce_blocks, sm_count)
    rows, att = dk.shape
    d = x.shape[1]
    want = outer_reduce_plain(x.double(), idx, dk.double())
    got, again = outer_reduce(x, idx, dk), outer_reduce(x, idx, dk)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"outer_reduce @ {shape_name}{tag}: two "
                             "launches differ")
    work = (rows * d * x.element_size() + (4 * rows if idx is not None
                                           else 0)
            + rows * att * 4 + (d + 1) * att * 4,
            2 * rows * d * att + rows * att)
    library = None
    if idx is None and x.dtype == torch.float32:
        xr = x[:rows]
        library = lambda: (torch.mm(xr.t(), dk), dk.sum(0))  # noqa: E731
    blocks = reduce_blocks(rows, d, att, sm_count(x.device))
    return time_case(
        "outer_reduce", "[x | 1]^T dk" + (" gathered" if idx is not None
                                          else ""), shape_name,
        f"rows={rows} D={d} ATT={att}{tag} ({blocks} blocks)",
        lambda: outer_reduce(x, idx, dk),
        lambda: outer_reduce_plain(x, idx, dk), work, library,
        reference=lambda: tuple(t.float() for t in want), timed=timed)


LIBRARY_CHECKED = ("csr_spmm", "edge_dot", "segment_norm",
                   "segment_norm_bwd", "dual_scatter", "dual_gather",
                   "blocked_spmm", "blocked_sddmm", "node_project",
                   "outer_reduce")


def print_slower_than_library(rows):
    """One line for every timed shape at which a kernel of
    ``LIBRARY_CHECKED`` (K1, K2, K3, K4, K10, K11, K15, K16, the node
    projections or the dKw reduction) took longer than its library call,
    each the median of ``LIBRARY_SESSIONS`` profiler sessions in turns. A
    slow kernel does not fail the run: its times are written down."""
    slower = [r for r in rows
              if r["kernel"].split()[0] in LIBRARY_CHECKED
              and r.get("library_ms") is not None
              and r["ms"] > r["library_ms"]]
    for r in slower:
        print(f"[slower than library] {r['kernel']} {r['check']} @ "
              f"{r['shape']} {r['dims']}: kernel {r['ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x; "
              f"medians)", flush=True)
    if not slower:
        print(f"[slower than library] no timed shape of "
              f"{', '.join(LIBRARY_CHECKED)} (medians)", flush=True)


def print_slower_than_plain(rows, names=("fused_rhs_bwd", "fused_rowmax")):
    """One line for every timed shape at which a kernel of ``names`` (K8
    with dxg and K7 by default; the run adds K18, K19 and K8's per-head
    mode), float32 or on bfloat16 tables, took longer than its plain
    version, or one line saying that none did. Slow does not fail the
    run."""
    slower = [r for r in rows if r["kernel"].split()[0] in names
              and ROWS not in r["kernel"] and "ms" in r
              and r["ms"] >= r["plain_ms"]]
    for r in slower:
        print(f"[slower than plain] {r['kernel']} @ {r['shape']} "
              f"{r['dims']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms", flush=True)
    if not slower:
        timed = sum(1 for r in rows if r["kernel"].split()[0] in names
                    and ROWS not in r["kernel"] and "ms" in r)
        print(f"[slower than plain] none of the {timed} timed shapes of "
              f"{' and '.join(names)}", flush=True)


PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # TF32 on the tensor cores, dense
# calls each timing of phase 3 takes, device time and host time alike: the
# host's work around them (the profiler sessions above all) is most of
# phase 3's time, and the device times of 10 calls agree with 20's
TIMED_CALLS = 10
# profiler sessions each of a kernel and its library call is timed in, in
# turns; their medians are compared (a library call's time has swung by 2x
# between runs, while its sessions in one process agree to 0.2%: PERF.md)
LIBRARY_SESSIONS = 3


def device_kernel_names(fn):
    """Names of the device events (kernels, memsets, copies) that calls of
    ``fn`` put on the card, in first-seen order: one profiler session of 25
    ms of calls (its first moments may lose events; the calls repeat)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, calls = time.perf_counter(), 0
        while calls < 3 or time.perf_counter() - t0 < 0.025:
            fn()
            torch.cuda.synchronize()
            calls += 1
    names = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in names:
            names.append(e.name)
    return names


def library_sessions(kern, library, first_ms):
    """Device times of ``kern`` (its first session already taken,
    ``first_ms``) and ``library`` in ``LIBRARY_SESSIONS`` profiler sessions
    each, in turns: (kernel's, library's)."""
    ks, ls = [first_ms], []
    for i in range(LIBRARY_SESSIONS):
        ls.append(device_ms(library, reps=TIMED_CALLS))
        if i + 1 < LIBRARY_SESSIONS:
            ks.append(device_ms(kern, reps=TIMED_CALLS))
    return ks, ls


def time_case(kname, what, shape_name, dims, kern, plain, work, library=None,
              reference=None, timed=True):
    """Check one kernel call against its plain version and time both.
    ``work`` is (compulsory bytes, float32 operations) of the call, from
    its shapes, and for a kernel with products on the tensor cores a third
    count, their operations as TF32 products (the operations bound is
    then the larger of the two counts' times at their rates); ``library``
    an optional single PyTorch call computing the same function; ``reference`` an optional stricter stand-in for the
    plain version in the comparison (the timed calls stay ``kern`` and
    ``plain``). ``timed=False`` only compares."""
    from graph_neural_pde_tpu_torch.probes.gather import agree, time_ms
    got, want = kern(), (reference or plain)()
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    errs = [agree(f"{kname} {what} [{i}] @ {shape_name} {dims}", g_, w_)
            for i, (g_, w_) in enumerate(zip(got, want))]
    abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    head = (f"[kernels] {kname:17s} {what:34s} {shape_name:14s} {dims}: "
            f"max_abs_err={abs_err:.3e} rel={rel:.3e}")
    row = dict(kernel=kname, check=what, shape=shape_name, dims=dims,
               max_abs_err=abs_err, max_rel_err=rel)
    if not timed:
        print(head, flush=True)
        return row
    import statistics
    call_k, call_p = (time_ms(f, reps=TIMED_CALLS) for f in (kern, plain))
    dev_k, dev_p = (device_ms(f, reps=TIMED_CALLS) for f in (kern, plain))
    measured = dev_k is not None and dev_p is not None
    lib_ms = lib_fastest = None
    if library is not None and measured:
        # the kernel and its library call in turns, medians compared
        print(f"[library] {kname} {what} @ {shape_name}: device kernels "
              f"{device_kernel_names(library)}", flush=True)
        ks, ls = library_sessions(kern, library, dev_k)
        dev_k, lib_ms = statistics.median(ks), statistics.median(ls)
        lib_fastest = min(ls)
        print(f"[library] {kname} {what} @ {shape_name} {dims}: sessions "
              f"kernel {' '.join(f'{t:.4f}' for t in ks)} (median "
              f"{dev_k:.4f}), library {' '.join(f'{t:.4f}' for t in ls)} "
              f"(median {lib_ms:.4f}, fastest {lib_fastest:.4f}) ms",
              flush=True)
    elif library is not None:
        lib_ms = time_ms(library, reps=TIMED_CALLS)
    n_bytes, flops, *tensor = work
    tc_flops = tensor[0] if tensor else 0
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS, tc_flops / PEAK_TF32_FLOPS) * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    tc_txt = (f" + {tc_flops / 1e9:.3f} GFLOP of TF32 products"
              if tc_flops else "")
    dev_txt = (f"device {dev_k:.4f} ms, plain {dev_p:.4f} ms; "
               if measured else "device time not measured; ")
    lib_txt = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    print(f"{head}; {dev_txt}per call kernel {call_k:.4f} ms, plain "
          f"{call_p:.4f} ms; bound {bound_ms:.5f} ms by {bound_by} "
          f"({n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP{tc_txt})"
          f"{lib_txt}",
          flush=True)
    return dict(row, ms=dev_k if measured else call_k,
                plain_ms=dev_p if measured else call_p, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms,
                library_fastest_ms=lib_fastest)


def check_segment_kernels(shape_name, g, h, seed, dev="cuda"):
    """K3 in both modes and K4 in both modes, against their plain versions
    (``index_add`` over each edge's row or column), over rows and over
    columns: through the reverse-edge map ``rev`` on a symmetric graph,
    over the CSC view (``colptr``, ``col_perm``) on a directed one; two
    launches of K3 and of K4 on one input must be bit-identical, and
    neither may put a memset or a fill on the card (they write their
    padding). A
    line before each layout prints ``segment_design``'s (G, V) and the
    pieces. Library calls in softmax mode: ``torch.sparse.softmax`` for K3,
    its backward ``torch._sparse_softmax_backward_data`` for K4."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import (segment_norm,
                                                    segment_norm_bwd,
                                                    segment_norm_bwd_plain,
                                                    segment_norm_plain)
    from graph_neural_pde_tpu_torch.kernels.lanes import segment_design
    dev = torch.device(dev)
    g = g.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn((g.capacity, h), generator=gen, device=dev)
    ct = torch.randn((g.capacity, h), generator=gen, device=dev)
    # normalise takes positive weights (squareplus values, attention)
    weights = torch.rand((g.capacity, h), generator=gen, device=dev) + 0.05
    if g.rev is not None:
        layouts = (("rows", (g.rowptr, g.row, None), g.row_segments),
                   ("columns", (g.rowptr, g.row, g.rev), g.row_segments))
    else:
        layouts = (("columns over CSC",
                    (g.colptr, g.col_by_col, g.col_perm), g.col_segments),)
    n, nv, cap = g.num_nodes, g.num_valid, g.capacity
    for seg, _, pc in layouts:
        group, vec = segment_design(h, pc.n_edges / max(n, 1), scores,
                                    piece=pc.piece)
        print(f"[segment] {shape_name} {seg} H={h}: G={group} V={vec} (mean "
              f"segment {pc.n_edges / max(n, 1):.2f}); {pc.n_pieces} pieces "
              f"of <= {pc.piece}, {pc.n_multi} segments of several "
              f"({pc.n_slots} pieces), the longest {pc.longest}",
              flush=True)
    rows = []
    for mode, s in (("softmax", scores), ("normalise", weights)):
        for seg, args, pc in layouts:
            perm = args[2]
            first, den = segment_norm(*args, s, mode, pc)
            again = segment_norm(*args, s, mode, pc)
            ds = segment_norm_bwd(*args, first, ct, den, mode, pc)
            if not (torch.equal(first, again[0]) and torch.equal(den,
                                                                 again[1])
                    and torch.equal(ds, segment_norm_bwd(
                        *args, first, ct, den, mode, pc))):
                raise AssertionError(f"segment_norm {mode} {seg} @ "
                                     f"{shape_name}: two launches differ")
            # their own kernels only: no memset, no fill of the outputs
            others = [name for name in device_kernel_names(
                lambda: (segment_norm(*args, s, mode, pc),
                         segment_norm_bwd(*args, first, ct, den, mode, pc)))
                if "segment_norm" not in name]
            if others:
                raise AssertionError(f"segment_norm {mode} {seg} @ "
                                     f"{shape_name}: device operations "
                                     f"besides K3 / K4: {others}")
            dims = f"N={n} E={nv} H={h}"
            idx = n + 1 + (nv if perm is not None else 0)
            # K3 reads s and writes out (padding too) and den; K4 reads out
            # and g (and den, normalising) and writes ds; a handful of
            # operations per edge and head
            library = library_bwd = None
            if mode == "softmax":
                # the softmax over each row (each column: dim 0) of an
                # [N, N, H] sparse tensor; coalescing (set-up, untimed)
                # sums duplicate edges' scores
                coo = torch.sparse_coo_tensor(
                    torch.stack([g.row[:nv].long(), g.col[:nv].long()]),
                    s[:nv], (n, n, h)).coalesce()
                dim = 1 if perm is None else 0
                soft = torch.sparse.softmax(coo, dim=dim)
                gcoo = torch.sparse_coo_tensor(
                    soft.indices(), ct[:soft.values().shape[0]],
                    soft.shape).coalesce()

                def library(coo=coo, dim=dim):
                    return torch.sparse.softmax(coo, dim=dim)

                def library_bwd(gcoo=gcoo, soft=soft, dim=dim, coo=coo):
                    return torch._sparse_softmax_backward_data(gcoo, soft,
                                                               dim, coo)
            rows.append(time_case(
                "segment_norm", f"{mode} over {seg}", shape_name, dims,
                lambda: segment_norm(*args, s, mode, pc)[0],
                lambda: segment_norm_plain(*args, s, mode)[0],
                (4 * (idx + nv * h + cap * h + n * h), 4 * nv * h), library))
            rows.append(time_case(
                "segment_norm_bwd", f"{mode} over {seg}", shape_name, dims,
                lambda: segment_norm_bwd(*args, first, ct, den, mode, pc),
                lambda: segment_norm_bwd_plain(*args, first, ct, den, mode),
                (4 * (idx + 2 * nv * h + cap * h
                      + (n * h if mode != "softmax" else 0)), 5 * nv * h),
                library_bwd))
    print(f"[kernels] segment_norm @ {shape_name} H={h}: two launches of K3 "
          f"and of K4 bit-identical in every mode, no memset", flush=True)
    return rows


def check_column_sum(shape_name, g, d, seed, dev="cuda"):
    """K1 as the column-side sum of a directed graph, dx = A_w^T ct walked
    over the CSC view (``colptr``, gathering ``ct[row_by_col]`` with the
    weights ``w[col_perm]``), against ``index_add`` over the edges'
    columns; two launches must be bit-identical. Library: ``torch.sparse
    .mm`` of the transposed CSR."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import csr_spmm
    dev = torch.device(dev)
    g = g.to(dev)
    n, nv = g.num_nodes, g.num_valid
    gen = torch.Generator(device=dev).manual_seed(seed)
    ct = torch.randn((n, d), generator=gen, device=dev)
    w = torch.rand((g.capacity,), generator=gen, device=dev) * g.mask
    w_col = w[g.col_perm.long()]
    row_l, col_l = g.row.long()[:nv], g.col.long()[:nv]
    csc = (g.colptr, g.col_by_col, g.row_by_col)
    csr_t = torch.sparse_csr_tensor(g.colptr, g.row_by_col[:nv], w_col[:nv],
                                    size=(n, n))

    def kern():
        return csr_spmm(*csc, w_col, ct, n_edges=nv)

    if not torch.equal(kern(), kern()):
        raise AssertionError(f"csr_spmm over CSC @ {shape_name}: two "
                             f"launches differ")
    print_lanes("csr_spmm", shape_name, d, ct, mean_row=nv / n)
    return [time_case(
        "csr_spmm", "column sum dx = A_w^T ct over CSC", shape_name,
        f"N={n} E={nv} D={d}", kern,
        lambda: torch.zeros_like(ct).index_add(0, col_l,
                                               ct[row_l] * w[:nv, None]),
        (4 * (n + 1 + 2 * nv + 2 * n * d), 2 * nv * d),
        lambda: torch.sparse.mm(csr_t, ct),
        reference=lambda: torch.zeros_like(ct, dtype=torch.float64)
        .index_add(0, col_l, ct[row_l].double() * w[:nv, None].double())
        .float())]


def check_head_sum(shape_name, g, d, h, seed, dev="cuda"):
    """K1 in table mode as K11's dx (``column_head_sum``): the heads'
    cotangents read as the [N*H, D/H] table and summed over the CSC view,
    weighted by the attention u, against its plain version in float64; two
    launches must be bit-identical, and ``column_head_sum`` must return the
    launch's output bit for bit. The launch is timed on the arguments
    ``column_head_sum`` builds, as the library call ``torch.sparse.mm`` of
    the same [N, N*H] matrix is on its prebuilt CSR."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import csr_spmm, csr_spmm_plain
    from graph_neural_pde_tpu_torch.kernels.dual_scatter import \
        column_head_sum
    dev = torch.device(dev)
    g = g.to(dev)
    n, nv = g.num_nodes, g.num_valid
    gen = torch.Generator(device=dev).manual_seed(seed)
    # positive attention, 0 on padding, as squareplus gives
    u = (torch.rand((g.capacity, h), generator=gen, device=dev) + 0.05) \
        * g.mask[:, None]
    ct_num = torch.randn((n, d), generator=gen, device=dev)
    # column_head_sum's launch, spelled out for the plain versions
    heads = torch.arange(h, dtype=torch.int32, device=dev)
    idx = (g.row_by_col[:, None] * h + heads).reshape(-1)
    seg = g.col_by_col.repeat_interleave(h)
    w = u[g.col_perm.long()].reshape(-1).contiguous()
    table = ct_num.view(n * h, d // h)
    csr = ((g.colptr * h).contiguous(), seg, idx, w)
    mat = torch.sparse_csr_tensor(csr[0], idx[:nv * h], w[:nv * h],
                                  size=(n, n * h))

    def kern():
        return csr_spmm(*csr, table, table=True, n_edges=nv * h)

    if not torch.equal(kern(), kern()):
        raise AssertionError(f"csr_spmm as K11's dx @ {shape_name}: two "
                             f"launches differ")
    if not torch.equal(column_head_sum(g, u, ct_num), kern()):
        raise AssertionError(f"column_head_sum @ {shape_name}: not K1's "
                             f"launch on the table")
    print_lanes("csr_spmm", shape_name, d // h, table, mean_row=nv * h / n)
    # reads the column pointer, per head and edge the table row and the
    # weight, the table once, and writes [N, D/H]; 2 flop per edge, head
    # and column of the table
    return [time_case(
        "csr_spmm", "table mode: K11's dx over CSC", shape_name,
        f"N={n} E={nv} D={d} H={h} table width {d // h}", kern,
        lambda: csr_spmm_plain(*csr, table),
        (4 * (n + 1 + 2 * nv * h + n * d + n * (d // h)), 2 * nv * d),
        lambda: torch.sparse.mm(mat, table),
        reference=plain64(csr_spmm_plain, *csr, table))]


def rhs_operands(g, d, att, h, score, seed, dev, feat=None):
    """Seeded operands of one attention RHS evaluation on ``dev``: the
    graph moved there, a normal sampler, the CSR arrays, (x, Qw, qb, Kw,
    kb, gmax) and the kernels' keyword arguments (with the score's
    scalars). For exp_kernel_beltrami ``att`` is the packed width and the
    projections are block-structured as ``models.functions.pack_beltrami``
    builds them: the first ``feat`` of x's columns (features; 3/4 of them
    by default) map to the first half of q and k, the rest (positions) to
    the second half, with Kp drawn apart from Qp; var and ls hold the two
    factors' scalars."""
    import torch
    dev = torch.device(dev)
    g = g.to(dev)
    n = g.num_nodes
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # projections with O(1) rows, so the scores stay O(1)
    x = randn(n, d)
    qw, kw = randn(d, att, scale=d ** -0.5), randn(d, att, scale=d ** -0.5)
    if score == BELTRAMI:
        feat = (3 * d) // 4 if feat is None else feat
        for w in (qw, kw):
            w[feat:, :att // 2] = 0.0
            w[:feat, att // 2:] = 0.0
    qb, kb = randn(att, scale=0.1), randn(att, scale=0.1)
    gmax = torch.full((1,), 0.25, device=dev)
    sp = {}
    if score == "exp_kernel":
        sp = dict(var=torch.full((1,), 1.3, device=dev),
                  ls=torch.full((1,), 0.8, device=dev))
    elif score == BELTRAMI:
        sp = dict(var=torch.tensor([1.3, 0.9], device=dev),
                  ls=torch.tensor([0.8, 1.4], device=dev))
    return (g, randn, (g.rowptr, g.row, g.col), (x, qw, qb, kw, kb, gmax),
            dict(heads=h, score=score, **sp))


def projection_ops(d, att, score):
    """float32 operations of one node's q (or k) projection, or of one
    product of a dk row by Kw^T or x^T: 2 D ATT. Under exp_kernel_beltrami
    ``att`` is the packed width and half of each packed weight is zero by
    construction (features to the first half, positions to the second), so
    the work needed is 2 (Dx + Dp) ATT/2 = D att."""
    return d * att if score == BELTRAMI else 2 * d * att


def payload_ops(n, nv, d, att, h, score):
    """float32 operations the work of K18, K19 and K8's per-head mode needs
    over N nodes and E payload rows: (K18, K19, per-head mode).

    For scaled_dot the score is linear in k_e, so Kw folds into the query
    once a node: r_nh = Kw_h q_nh and s_eh = (<x_g[e], r_nh> + <q_nh,
    kb_h>) / sqrt(d_k). Per edge that leaves H dots over D for the scores
    and H axpys over D for num (K18: 4 H D); the scores alone (K19, whose
    q is an input: 2 H D); backward, the scores, the H dots with ct_num,
    sum_e ds_eh x_g[e] (whose product by Kw_h per node gives dq and by q_nh
    gives dKw) and dxg = sum_h (u_eh ct_num[n, h] + ds_eh r_nh / sqrt(d_k))
    (10 H D). Per node: q and the fold (K18), the fold (K19), q, the fold,
    dq and dKw (backward), 2 D ATT each. The other families need each
    edge's key (norms, means or distances of k_e): K18 projects it on the
    tensor cores (:func:`key_tile_ops`), and leaves q, the scores (2 ATT)
    and num (2 H D) here; backward three products of D x ATT an edge (k_e,
    dk_e Kw^T, x_g^T dk_e), the score's derivatives (~6 ATT) and the dots
    and dxg's sum over heads (4 H D). K19 is scaled_dot only (None
    otherwise)."""
    proj = projection_ops(d, att, score)
    if score == "scaled_dot":
        return (n * (2 * proj + 2 * att) + nv * 4 * h * d,
                n * (proj + 2 * att) + nv * 2 * h * d,
                n * (4 * proj + 4 * att) + nv * 10 * h * d)
    return (n * proj + nv * (2 * att + 2 * h * d), None,
            n * proj + nv * (3 * proj + 6 * att + 4 * h * d))


def key_tile_ops(nv, d, att, score, elem):
    """Operations of K18's key tile for the families that need each edge's
    key, as TF32 products on the tensor cores: an edge's projection
    (:func:`projection_ops`) as three products (3xTF32: the high parts, and
    each high part by the other's low part), or two over a bfloat16
    payload (``elem`` 2), whose rows are TF32 values already."""
    return nv * projection_ops(d, att, score) * (2 if elem == 2 else 3)


def print_walk_design(kname, shape_name, dims, g, d, att, h, score,
                      multi_rows=False):
    """The design variant the walk of K6 or K13 (``kernels.fused_rhs.
    fwd_design``), of K9, K14, K12 or K8 without dxg (``sym_design``), of
    K8 with dxg (``dxg_design``: the walk's tiles and the dxg pass's
    tensor-core tile) or of K7 (``rowmax_design``) runs at these widths
    over ``g``'s row pieces; with ``multi_rows``, fails unless some row
    has several pieces (the walk's merge pass runs)."""
    from graph_neural_pde_tpu_torch.kernels.fused_rhs import (dxg_design,
                                                              fwd_design,
                                                              rowmax_design,
                                                              sym_design)
    pc = g.row_pieces
    # K12 and K8 without dxg take K9's tiles (K12's plain mode: KD unused)
    if kname.startswith("fused_rowmax"):
        design = rowmax_design(att, h)
    elif kname.split()[0] == "fused_rhs_bwd" and ROWS not in kname:
        design = dxg_design(d, att, h, score)
    else:
        design = (fwd_design if kname in ("fused_rhs_fwd", "norm1_fwd")
                  else sym_design)(d, att, h, score)
    print(f"[kernels] {kname} walk @ {shape_name} {dims}: {design} over "
          f"{pc.n_pieces} row pieces of at most {pc.piece} edges "
          f"({pc.n_multi} rows of several, longest row {pc.longest} edges)",
          flush=True)
    if multi_rows and pc.n_multi == 0:
        raise AssertionError(f"{kname} @ {shape_name}: no row of several "
                             "pieces, the merge pass does not run")


def check_fused_kernels(shape_name, g, d, att, h, score, seed, timed=True,
                        dev="cuda", feat=None, payload=None, row_bf16=False,
                        multi_rows=False):
    """K6 (plain with numerators, shifted, folded), K7, K8 and K9 (every
    output) against their plain versions; two launches of each must be
    bit-identical. On a directed graph (no reverse-edge map) K9 does not
    apply. ``timed=False`` only compares; ``feat`` as in ``rhs_operands``;
    ``multi_rows`` as in ``check_norm1_kernels`` (K6's and K9's merge; on
    a symmetric graph also K8 without dxg over the same row pieces).

    ``payload=torch.bfloat16`` (the JAX package's bf16 payload) checks
    every one of them on the bf16 tables: the column table is x cast to
    bfloat16, its k table rounded as the package rounds k_e, beside the row
    side x, float32 or (``row_bf16``, the bf16 ODE state) x itself in
    bfloat16; K8's and K9's plain versions are evaluated in float64 beside
    the same bfloat16 table. K6 with the exact mode's shifts is named
    "fused_rhs_fwd bf16 shifted" there (its launches are counted apart)."""
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    g, randn, csr, ops, kw_f = rhs_operands(g, d, att, h, score, seed, dev,
                                            feat)
    bf16 = payload == torch.bfloat16
    if row_bf16:
        ops = (ops[0].to(torch.bfloat16),) + ops[1:]
    kw_x = dict(xcol=ops[0].to(torch.bfloat16)) if bf16 else {}
    symmetric = g.rev is not None
    n, nv, cap = g.num_nodes, g.num_valid, g.capacity
    alpha = torch.full((1,), 0.37, device=ops[1].device)
    shifts = randn(cap, h, scale=0.5)
    ct_ax = randn(n, d)
    # den's cotangent positive, so that the sums over all edges (dgmax, the
    # exp_kernel scalars) do not cancel and their own size is a fair scale
    ct_den = 1.0 + randn(n, h, scale=0.1)
    # the row pieces K6-K9 walk: the graph's own, as on every path
    kw_p = dict(pieces=g.row_pieces)
    _, den, _ = K.fused_rhs_fwd(*csr, *ops, **kw_x, **kw_p, **kw_f)
    recip_p = (1.0 / (h * (den + 1e-16))).contiguous()
    cts = (ct_ax, recip_p, ct_den)

    def f64(t):
        return (t.double() if t.is_floating_point()
                and t.dtype != torch.bfloat16 else t)

    def plain64(fn, **kw):
        """The plain version in float64 on the same float32 inputs (the
        bfloat16 tables as they are)."""
        kw = {k: (f64(v) if torch.is_tensor(v) else v) for k, v in kw.items()}
        out = fn(*csr, *map(f64, ops), *map(f64, cts), **kw)
        return tuple(o.float() for o in out if o is not None)

    def some(out):
        return tuple(o for o in out if o is not None)

    # compulsory bytes: indices, the row side x and the column table (one
    # tensor but for a float32 row side beside the bf16 payload), the
    # projections' weights (inputs read once, outputs written once; the
    # scratch tables do not count); float32 operations: every node's q and
    # k projections, and per edge the scores and the aggregation (see the
    # note in csrc/fused_rhs.cu)
    x_bytes = ops[0].element_size() * n * d
    if bf16 and not row_bf16:
        x_bytes += 2 * n * d
    base_bytes = 4 * (n + 1 + nv + 2 * d * att + 2 * att) + x_bytes
    proj = projection_ops(d, att, score)
    fwd_ops = 2 * n * proj + nv * (2 * att + 2 * h * d)
    node_b = 4 * n * (d + 2 * h)             # ct_ax, recip_p, ct_den
    cases = [
        ("fused_rhs_fwd", "ax, den, num",
         lambda: some(K.fused_rhs_fwd(*csr, *ops, want_num=True, **kw_x,
                                      **kw_p, **kw_f)),
         lambda: some(K.fused_rhs_fwd_plain(*csr, *ops, want_num=True,
                                            **kw_x, **kw_f)),
         (base_bytes + 4 * n * (d + h + h * d), fwd_ops), None),
        ("fused_rhs_fwd", "ax, den with per-edge shifts",
         lambda: some(K.fused_rhs_fwd(*csr, *ops, shifts=shifts, **kw_x,
                                      **kw_p, **kw_f)),
         lambda: some(K.fused_rhs_fwd_plain(*csr, *ops, shifts=shifts,
                                            **kw_x, **kw_f)),
         (base_bytes + 4 * (nv * h + n * (d + h)), fwd_ops), None),
        ("fused_rhs_fwd", "folded f = alpha (ax - x)",
         lambda: some(K.fused_rhs_fwd(*csr, *ops, alpha=alpha, **kw_x,
                                      **kw_p, **kw_f)),
         lambda: some(K.fused_rhs_fwd_plain(*csr, *ops, alpha=alpha, **kw_x,
                                            **kw_f)),
         (base_bytes + 4 * n * (d + h), fwd_ops + 2 * n * d), None),
        ("fused_rhs_bwd", "dq, dxg, dkw, dkb, dgmax[, dvar, dls]",
         lambda: some(K.fused_rhs_bwd(*csr, *ops, *cts, shifts=shifts,
                                      **kw_p, **kw_x, **kw_f)),
         lambda: some(K.fused_rhs_bwd_plain(*csr, *ops, *cts, shifts=shifts,
                                            **kw_x, **kw_f)),
         # per edge still dk_e Kw^T and x_c^T dk_e
         (base_bytes + node_b + 4 * (nv * h + n * att + nv * d + d * att),
          2 * n * proj + nv * (2 * proj + 6 * att + 4 * d)),
         lambda: plain64(K.fused_rhs_bwd_plain, shifts=shifts, **kw_x,
                         **kw_f)),
        ("fused_rhs_bwd_sym", "dq, dxrow, dkw, dkb, dgmax[, dvar, dls]",
         lambda: some(K.fused_rhs_bwd_sym(*csr, *ops, *cts,
                                          **kw_p, **kw_x,
                                          **kw_f)),
         lambda: some(K.fused_rhs_bwd_sym_plain(*csr, *ops, *cts, **kw_x,
                                                **kw_f)),
         # per node q, k, dk Kw^T and x^T dk; per edge two scores' worth
         (base_bytes + node_b + 4 * (n * att + n * d + d * att),
          4 * n * proj + nv * (10 * att + 6 * d)),
         lambda: plain64(K.fused_rhs_bwd_sym_plain, **kw_x, **kw_f)),
    ]
    if not symmetric:
        cases.pop()
    elif multi_rows:
        # K8 without dxg over the same row pieces, whose merge must run
        cases.append((
            ROWS, "dq, dgmax[, dvar, dls]",
            lambda: some(K.fused_rhs_bwd(*csr, *ops, *cts, want_dxg=False,
                                         **kw_p, **kw_x, **kw_f)),
            lambda: some(K.fused_rhs_bwd_plain(*csr, *ops, *cts,
                                               want_dxg=False, **kw_x,
                                               **kw_f)),
            (base_bytes + node_b + 4 * n * att,
             2 * n * proj + nv * (6 * att + 2 * d)),
            lambda: plain64(K.fused_rhs_bwd_plain, want_dxg=False, **kw_x,
                            **kw_f)))
    if score == "scaled_dot":
        cases.insert(3, (
            "fused_rowmax", "row maxima of the scores",
            lambda: (K.fused_rowmax(*csr, *ops[:5], heads=h, **kw_p,
                                    **kw_x),),
            lambda: (K.fused_rowmax_plain(*csr, *ops[:5], heads=h, **kw_x),),
            (base_bytes + 4 * n * h, 2 * n * proj + nv * 2 * att),
            None))
    tag = ""
    if bf16:
        cases = [(kname + (" bf16 shifted" if "shifts" in c[0] else " bf16"),
                  *c) for kname, *c in cases]
        tag = " row bf16" if row_bf16 else " bf16"
    dims = f"N={n} E={nv} D={d} ATT={att} H={h} {score}{tag}"
    print_walk_design("fused_rhs_fwd", shape_name, dims, g, d, att, h, score,
                      multi_rows)
    print_walk_design("fused_rhs_bwd", shape_name, dims, g, d, att, h, score,
                      multi_rows)
    if score == "scaled_dot":
        print_walk_design("fused_rowmax", shape_name, dims, g, d, att, h,
                          score, multi_rows)
    if symmetric:
        print_walk_design("fused_rhs_bwd_sym", shape_name, dims, g, d, att,
                          h, score)
        if multi_rows:
            print_walk_design(ROWS, shape_name, dims, g, d, att, h, score,
                              multi_rows)
    rows = []
    for kname, what, kern, plain, work, ref in cases:
        rows.append(time_case(kname, what, shape_name, dims, kern, plain,
                              work, reference=ref, timed=timed))
        if not all(torch.equal(a, b) for a, b in zip(kern(), kern())):
            raise AssertionError(f"{kname} {what} {score} @ {shape_name}: "
                                 f"two launches differ")
    print(f"[kernels] {', '.join(sorted({c[0] for c in cases}))} @ "
          f"{shape_name} {score}{tag}: two launches bit-identical in every "
          f"output", flush=True)
    return rows


def check_exact_shifts(shape_name, n, d, att, h, seed, dev="cuda"):
    """K7's row maxima as K6's shifts (the exact mode) over a graph whose
    rows hold one edge each, with gmax = 0: each row's shifted score is
    then exactly 0 and its den exactly 1.0 in every head, provided K7
    scores each edge as K6 does, bit for bit. Float32, and on the bfloat16
    column table beside a float32 row side; fails on any other den."""
    import numpy as np
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.ops.graph import make_graph
    rng = np.random.default_rng(seed)
    g = make_graph(np.arange(n), rng.permutation(n),
                   num_nodes=n).sort_by_row()
    g, _, csr, ops, kw_f = rhs_operands(g, d, att, h, "scaled_dot", seed,
                                        dev)
    ops = ops[:5] + (torch.zeros(1, device=ops[0].device),)
    for table in ("float32", "bfloat16"):
        kw_x = ({} if table == "float32"
                else dict(xcol=ops[0].to(torch.bfloat16)))
        smax = K.fused_rowmax(*csr, *ops[:5], heads=h, pieces=g.row_pieces,
                              **kw_x)
        shifts = smax[g.row.long()].contiguous()
        _, den, _ = K.fused_rhs_fwd(*csr, *ops, shifts=shifts,
                                    pieces=g.row_pieces, **kw_x, **kw_f)
        off = int((den != 1.0).sum())
        if off:
            raise AssertionError(
                f"K7 / K6 exact shifts @ {shape_name} {table}: den is not "
                f"exactly 1.0 in {off} of {den.numel()} rows and heads "
                f"(furthest {float((den - 1.0).abs().max()):.3e})")
        print(f"[kernels] fused_rowmax as fused_rhs_fwd's shifts @ "
              f"{shape_name} N={n} D={d} ATT={att} H={h} {table}, one edge "
              f"a row, gmax 0: den exactly 1.0 in every row and head",
              flush=True)


def oracle_graph(seed: int, n: int = 512, e: int = 4096):
    """The JAX bench oracle's graph (``bench.py:165-168``): ``e`` edges at
    sorted uniform rows and uniform columns over ``n`` nodes, row-sorted
    as the port's kernels read it."""
    import numpy as np
    from graph_neural_pde_tpu_torch.ops.graph import make_graph
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, n, e))
    return make_graph(row, rng.integers(0, n, e), num_nodes=n).sort_by_row()


def check_aggregate_kernels(shape_name, g, d, att, h, score, seed,
                            timed=True, dev="cuda", payload=None,
                            row_bf16=False, square_plus=False,
                            kernels=None):
    """K18 ``fused_aggregate`` (and with per-edge shifts), K19
    ``fused_score_max`` (scaled_dot) and K8's per-head mode
    ``fused_rhs_bwd_heads`` (every output, against the plain version in
    float64 on the same inputs) over a random per-edge payload x_g
    [E_pad, D] against their plain versions; two launches of each must be
    bit-identical. Each walks the graph's row pieces (``scatter_pieces``).
    ``timed=False`` only compares; ``kernels`` names the kernels checked
    (default: all of them).

    ``payload=torch.bfloat16`` (the JAX package's bf16 payload) draws x_g
    in bfloat16, beside node rows x in float32 or (``row_bf16``, the bf16
    ODE state) in bfloat16; the plain versions widen them where they read
    them, and the rows are named "<kernel> bf16". ``square_plus``: u is
    squareplus of the shifted score, not its exp."""
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    g, randn, csr, ops, kw_f = rhs_operands(g, d, att, h, score, seed, dev)
    rowptr, row = csr[:2]
    x, qw, qb, kw, kb, gmax = ops
    n, nv, cap = g.num_nodes, g.num_valid, g.capacity
    bf16 = payload == torch.bfloat16
    x_g = randn(cap, d)
    if bf16:
        x_g = x_g.to(torch.bfloat16)
    if row_bf16:
        x = x.to(torch.bfloat16)
    shifts = randn(cap, h, scale=0.5)
    ct_num = randn(n, h * d)
    # den's cotangent positive, as in check_fused_kernels
    ct_den = 1.0 + randn(n, h, scale=0.1)
    q = (x.float() @ qw + qb).contiguous()
    agg = (rowptr, row, x, x_g, qw, qb, kw, kb, gmax)
    bwd = agg + (ct_num, ct_den)
    # K18's and the per-head mode's walks take the graph's row pieces
    kw_f = dict(kw_f, pieces=g.scatter_pieces, square_plus=square_plus)
    kw_p = {k: v for k, v in kw_f.items() if k != "pieces"}

    def plain64(**kw):
        """K8's per-head plain version in float64 on the same inputs."""
        kw = {k: (v.double() if torch.is_tensor(v) else v)
              for k, v in kw.items() if k != "pieces"}
        out = K.fused_rhs_bwd_heads_plain(
            *(t.double() if t.is_floating_point() else t for t in bwd), **kw)
        return tuple(o.float() for o in out if o is not None)

    def some(out):
        return tuple(o for o in out if o is not None)

    # compulsory bytes: rowptr, x, the payload's valid rows (at their
    # element sizes), the projections' weights and the outputs; float32
    # operations as payload_ops counts them
    agg_ops, max_ops, bwd_ops = payload_ops(n, nv, d, att, h, score)
    # the key families' keys: TF32 products on the tensor cores
    agg_ops = ((agg_ops,) if score == "scaled_dot" else
               (agg_ops, key_tile_ops(nv, d, att, score, x_g.element_size())))
    xg_bytes = x_g.element_size() * nv * d
    base_bytes = (4 * (n + 1 + 2 * d * att + 2 * att)
                  + x.element_size() * n * d + xg_bytes)
    cases = [
        ("fused_aggregate", "num, den",
         lambda: K.fused_aggregate(*agg, **kw_f),
         lambda: K.fused_aggregate_plain(*agg, **kw_p),
         (base_bytes + 4 * n * (h * d + h), *agg_ops), None),
        ("fused_aggregate", "num, den with per-edge shifts",
         lambda: K.fused_aggregate(*agg, shifts=shifts, **kw_f),
         lambda: K.fused_aggregate_plain(*agg, shifts=shifts, **kw_p),
         (base_bytes + 4 * (nv * h + n * (h * d + h)), *agg_ops), None),
        ("fused_rhs_bwd_heads", "dq, dxg, dkw, dkb, dgmax[, dvar, dls]",
         lambda: some(K.fused_rhs_bwd_heads(*bwd, **kw_f)),
         lambda: some(K.fused_rhs_bwd_heads_plain(*bwd, **kw_p)),
         (base_bytes + 4 * (n * (h * d + h) + n * att + nv * d + d * att
                            + att), bwd_ops),
         lambda: plain64(**kw_f)),
    ]
    if score == "scaled_dot":
        cases.insert(2, (
            "fused_score_max", "global maximum of the scores",
            lambda: K.fused_score_max(rowptr, row, q, x_g, kw, kb, heads=h,
                                      pieces=g.scatter_pieces),
            lambda: K.fused_score_max_plain(rowptr, row, q, x_g, kw, kb,
                                            heads=h),
            (4 * (n + 1 + n * att + d * att + att + 1) + xg_bytes, max_ops),
            None))
    if kernels is not None:
        cases = [c for c in cases if c[0] in kernels]
    tag = " squareplus" if square_plus else ""
    if bf16:
        cases = [(kname + " bf16", *c) for kname, *c in cases]
        tag += " row bf16" if row_bf16 else " f32 row"
    dims = (f"N={n} E={nv} D={d} ATT={att} H={h} {score} payload [E, D]"
            f"{' bf16' if bf16 else ''}{tag}")
    if score == "scaled_dot":
        print_payload_design(shape_name, dims, g, x_g, h, att)
    rows = [time_case(kname, what, shape_name, dims, kern, plain, work,
                      reference=ref, timed=timed)
            for kname, what, kern, plain, work, ref in cases]
    if score == "scaled_dot" and timed:
        print(f"[payload] launches of one call by pass @ {shape_name} "
              f"{dims}: fused_aggregate "
              f"{launches_by_pass(lambda: K.fused_aggregate(*agg, **kw_f))}; "
              f"fused_rhs_bwd_heads "
              f"{launches_by_pass(lambda: K.fused_rhs_bwd_heads(*bwd, **kw_f))}",
              flush=True)
    for kname, what, kern, *_ in cases:
        first, again = kern(), kern()
        if not isinstance(first, tuple):
            first, again = (first,), (again,)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{kname} ({what}) {score} @ {shape_name}: "
                                 f"two launches differ")
    print(f"[kernels] {', '.join(sorted({c[0] for c in cases}))} @ "
          f"{shape_name} {score}{' bf16 payload' if bf16 else ''}{tag}: two "
          f"launches bit-identical in every output", flush=True)
    return rows


def print_payload_design(shape_name, dims, g, x_g, h, att):
    """The scaled-dot payload walks' design at these widths over ``g``:
    the lane group and vector width (``kernels/lanes.py``, payload_walk),
    the row pieces (``Graph.scatter_pieces``) and the per-head mode's node
    pass (``kernels/fused_rhs.py``, node_design and node_ranges)."""
    import torch
    from graph_neural_pde_tpu_torch.kernels.dense import sm_count
    from graph_neural_pde_tpu_torch.kernels.fused_rhs import (node_design,
                                                              node_ranges)
    from graph_neural_pde_tpu_torch.kernels.lanes import lanes
    group, vec = lanes("payload_walk", x_g.shape[1], x_g, heads=h)
    pc = g.scatter_pieces
    node = node_design(x_g.shape[1], att, h)
    ranges = node_ranges(g.num_nodes, x_g.shape[1], att, h,
                         sm_count(torch.device("cuda")))
    print(f"[payload] design @ {shape_name} {dims}: fold in the walk, lanes "
          f"G={group} V={vec}, {pc.n_pieces} row pieces ({pc.n_multi} rows "
          f"of several, longest row {pc.longest} edges); node pass "
          f"{ranges} ranges x {h * node['col_blocks']} blocks of "
          f"{node['threads']} threads, R={node['rows']} JC={node['cols']}, "
          f"{node['shared']} B shared", flush=True)


def launches_by_pass(fn) -> dict:
    """The launches one call of ``fn`` (K18 or the per-head mode) makes by
    pass: the walk (with its merge), q's projection, and the per-head
    mode's node pass (dq, dKw, dKb, dgmax)."""
    from graph_neural_pde_tpu_torch import kernels
    counters = {"walk": [kernels.fused_aggregate, kernels.fused_rhs_bwd_heads],
                "node_project": [kernels.node_project],
                "node_pass": [kernels.fused_rhs_bwd_heads]}
    attr = {"walk": "walk_launches", "node_project": "launches",
            "node_pass": "node_launches"}

    def total(key):
        return sum(getattr(k, attr[key]) for k in counters[key])

    before = {key: total(key) for key in counters}
    fn()
    return {key: total(key) - before[key] for key in counters}


def check_column_rhs_kernels(shape_name, g, d, att, h, score, seed,
                             timed=True, dev="cuda", feat=None, payload=None,
                             row_bf16=False, piece=None, multi_rows=False):
    """K17 (x[col]'s cotangent walked over the CSC view of a directed
    graph, and dkw, dkb from each column's summed dk) and K8 without its
    per-edge dxg (dq, dgmax), the two kernels of the column-plan backward,
    against their plain versions evaluated in float64 on the same float32
    inputs; two launches of each must be bit-identical. ``timed=False``
    only compares; ``feat`` as in ``rhs_operands``; ``payload`` and
    ``row_bf16`` as in ``check_fused_kernels`` (the bfloat16 column table,
    the plain versions in float64 beside it). K17 walks the graph's column
    pieces, or pieces of ``piece`` edges (short ones put the second pass
    to work on a small graph). K8 without dxg walks the graph's row
    pieces; ``multi_rows`` asserts that some row has several, so that its
    merge pass runs."""
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.ops.graph import column_pieces
    g, randn, csr, ops, kw_f = rhs_operands(g, d, att, h, score, seed, dev,
                                            feat)
    if g.rev is not None:
        raise AssertionError(f"{shape_name}: not a directed graph")
    bf16 = payload == torch.bfloat16
    if row_bf16:
        ops = (ops[0].to(torch.bfloat16),) + ops[1:]
    kw_x = dict(xcol=ops[0].to(torch.bfloat16)) if bf16 else {}
    n, nv = g.num_nodes, g.num_valid
    csc = (g.colptr, g.col_by_col, g.row_by_col)
    ct_ax = randn(n, d)
    ct_den = 1.0 + randn(n, h, scale=0.1)
    _, den, _ = K.fused_rhs_fwd(*csr, *ops, pieces=g.row_pieces, **kw_x,
                                **kw_f)
    recip_p = (1.0 / (h * (den + 1e-16))).contiguous()
    cts = (ct_ax, recip_p, ct_den)

    def f64(t):
        return (t.double() if torch.is_tensor(t) and t.is_floating_point()
                and t.dtype != torch.bfloat16 else t)

    def plain64(fn, index, **kw):
        out = fn(*index, *map(f64, ops), *map(f64, cts),
                 **{k: f64(v) for k, v in {**kw_f, **kw_x, **kw}.items()})
        if torch.is_tensor(out):
            return out.float()
        return tuple(o.float() for o in out if o is not None)

    def some(out):
        return tuple(o for o in out if o is not None)

    # compulsory bytes: the index arrays, x, the cotangents read per node,
    # the projections' weights and the outputs. float32 operations, from
    # this run's edge count: the node projections (2 N proj), per edge one
    # score per head and its derivative (~6 ATT) and the dot over D (2 D);
    # K17 adds the accumulation over D per edge (2 D) and, per node, the
    # product of the column's summed dk by Kw^T and the node's term of
    # dKw = sum_n x_n^T dk_n (2 N proj). K8 without dxg forms no dk.
    # with the bf16 payload the row side x and the column table (one tensor
    # but for a float32 row side beside it), as in check_fused_kernels
    x_bytes = ops[0].element_size() * n * d
    if bf16 and not row_bf16:
        x_bytes += 2 * n * d
    base_bytes = 4 * (n + 1 + nv + 2 * d * att + 2 * att) + x_bytes
    proj = projection_ops(d, att, score)
    node_b = 4 * n * (d + 2 * h)
    pieces = g.col_pieces if piece is None else column_pieces(g.colptr, piece)
    print(f"[kernels] fused_rhs_bwd_col pieces @ {shape_name}: "
          f"{pieces.n_pieces} pieces of at most {pieces.piece} edges over "
          f"{n} columns, {pieces.n_multi} columns of several pieces "
          f"({pieces.n_slots} partial rows), longest column "
          f"{pieces.longest} edges", flush=True)
    cases = [
        ("fused_rhs_bwd_col", "dx, dkw, dkb over CSC",
         lambda: K.fused_rhs_bwd_col(*csc, *ops, *cts, pieces=pieces, **kw_x,
                                     **kw_f),
         lambda: K.fused_rhs_bwd_col_plain(*csc, *ops, *cts, **kw_x,
                                           **kw_f),
         (base_bytes + node_b + 4 * (n * d + d * att + att),
          4 * n * proj + nv * (6 * att + 4 * d)),
         lambda: plain64(K.fused_rhs_bwd_col_plain, csc)),
        (ROWS, "dq, dgmax[, dvar, dls]",
         lambda: some(K.fused_rhs_bwd(*csr, *ops, *cts, want_dxg=False,
                                      pieces=g.row_pieces, **kw_x, **kw_f)),
         lambda: some(K.fused_rhs_bwd_plain(*csr, *ops, *cts,
                                            want_dxg=False, **kw_x, **kw_f)),
         (base_bytes + node_b + 4 * n * att,
          2 * n * proj + nv * (6 * att + 2 * d)),
         lambda: plain64(K.fused_rhs_bwd_plain, csr, want_dxg=False)),
    ]
    tag = ""
    if bf16:
        cases = [(kname + " bf16", *c) for kname, *c in cases]
        tag = " row bf16" if row_bf16 else " bf16"
    dims = f"N={n} E={nv} D={d} ATT={att} H={h} {score}{tag}"
    print_walk_design(ROWS, shape_name, dims, g, d, att, h, score,
                      multi_rows)
    rows = [time_case(kname, what, shape_name, dims, kern, plain, work,
                      reference=ref, timed=timed)
            for kname, what, kern, plain, work, ref in cases]
    if timed:
        # the piece length against its alternative, same inputs and call
        other = column_pieces(g.colptr, 64 if pieces.piece == 32 else 32)
        alt = device_ms(lambda: K.fused_rhs_bwd_col(
            *csc, *ops, *cts, pieces=other, **kw_x, **kw_f), reps=TIMED_CALLS)
        alt = "not measured" if alt is None else f"{alt:.4f} ms"
        print(f"[kernels] fused_rhs_bwd_col @ {shape_name} {score}{tag}: "
              f"pieces of {other.piece} edges ({other.n_pieces} pieces) "
              f"{alt} beside {pieces.piece} edges' {rows[0]['ms']:.4f} ms",
              flush=True)
    for kname, what, kern, *_ in cases:
        if not all(torch.equal(a, b) for a, b in zip(kern(), kern())):
            raise AssertionError(f"{kname} ({what}) {score} @ {shape_name}: "
                                 f"two launches differ")
    print(f"[kernels] fused_rhs_bwd_col, fused_rhs_bwd without dxg @ "
          f"{shape_name} {score}{tag}: two launches bit-identical in every "
          f"output", flush=True)
    return rows


def dual_library(g, u, x, ct_num, ct_den):
    """K10's and K11's functions as single PyTorch calls, used nowhere in
    the port (the library yardstick; float32): K10 is ``torch.sparse.mm``
    of the CSR [N*H, N] whose row n*H + h holds u[e, h] at col[e] for row
    n's edges, times ``[x | 1]`` (columns 0..D-1 num in K10's layout,
    column D den); K11's du is ``torch.sparse.sampled_addmm`` over the same
    pattern carrying ct_den[row, h], of ct_num viewed [N*H, D] and x^T; its
    dx ``torch.sparse.mm`` of that CSR's transpose by ct_num viewed [N*H,
    D]. Returns the three calls (the CSRs built here, outside them)."""
    import torch
    n, nv, d = g.num_nodes, g.num_valid, x.shape[1]
    h = u.shape[1]
    r, c = g.row[:nv].long(), g.col[:nv].long()
    heads = torch.arange(h, device=u.device)
    rh = (r[:, None] * h + heads).reshape(-1)
    cc = c[:, None].expand(nv, h).reshape(-1)

    def csr(rows, cols, vals, size):
        return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                       size).coalesce().to_sparse_csr()

    a = csr(rh, cc, u[:nv].reshape(-1), (n * h, n))
    pattern = csr(rh, cc, ct_den[r].reshape(-1), (n * h, n))
    a_t = csr(cc, rh, u[:nv].reshape(-1), (n, n * h))
    x1 = torch.cat([x, torch.ones((n, 1), device=x.device)], 1)
    ct_v, x_t = ct_num.view(n * h, d), x.t().contiguous()
    return (lambda: torch.sparse.mm(a, x1),
            lambda: torch.sparse.sampled_addmm(pattern, ct_v, x_t),
            lambda: torch.sparse.mm(a_t, ct_v))


def check_dual_kernels(shape_name, g, d, h, seed, timed=True, dev="cuda",
                       table=None):
    """K10 and K11 against their plain versions (K11 also against the plain
    version evaluated in float64 on the same float32 inputs); two launches
    of each must be bit-identical. On a directed graph (no ``rev``) K11
    writes du only and dx is K1 over the CSC view in table mode
    (``column_head_sum``), checked as one call. ``timed=False`` only
    compares. ``table=torch.bfloat16``: both read x as the bfloat16 column
    table (the bf16 payload; u, the cotangents and the outputs float32),
    the plain versions the same table, K11's float64 reference its values
    widened; their rows are named "<kernel> bf16". The kernels walk the
    graph's pieces as ``dual_scatter_add`` hands them over (K10
    ``Graph.scatter_pieces``, K11 ``Graph.row_pieces``). Timed in float32,
    each beside its library call (``dual_library``; K11's du and dx calls
    summed, each printed)."""
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.kernels.dual_scatter import \
        column_head_sum
    dev = torch.device(dev)
    g = g.to(dev)
    n, nv = g.num_nodes, g.num_valid
    gen = torch.Generator(device=dev).manual_seed(seed)
    # positive unnormalised attention, 0 on padding, as squareplus gives
    u = (torch.rand((g.capacity, h), generator=gen, device=dev) + 0.05) \
        * g.mask[:, None]
    x = torch.randn((n, d), generator=gen, device=dev)
    if table is not None:
        x = x.to(table)
    ct_num = torch.randn((n, h * d), generator=gen, device=dev)
    ct_den = torch.randn((n, h), generator=gen, device=dev)
    csr = (g.rowptr, g.row, g.col)
    tag = "" if table is None else " bf16"

    def gather64():
        out = K.dual_gather_plain(*csr, u.double(), x.double(),
                                  ct_num.double(), ct_den.double())
        return tuple(o.float() for o in out)

    # K10 reads rowptr, col, u and x and writes num and den; K11 reads
    # rowptr, col, rev, u, x and both cotangents and writes du and dx. 2
    # flop per edge, head and feature in K10, twice that in K11 (the dot
    # products of du, the sums of dx); a bf16 element of x is 2 bytes
    xb = x.element_size() * n * d
    scatter_work = (4 * (n + 1 + nv + nv * h + n * h * d + n * h) + xb,
                    2 * nv * h * d + nv * h)
    gather_work = (4 * (n + 1 + 2 * nv + 2 * nv * h + n * d + n * h * d
                        + n * h) + xb, 4 * nv * h * d)

    pieces = g.row_pieces

    def gather():
        du, dx = K.dual_gather(*csr, g.rev, u, x, ct_num, ct_den,
                               pieces=pieces)
        if g.rev is None:
            if dx is not None:
                raise AssertionError("dual_gather formed dx without rev")
            dx = column_head_sum(g, u, ct_num)
        return du, dx

    library = (None, None)
    if timed and table is None:
        k10_lib, du_lib, dx_lib = dual_library(g, u, x, ct_num, ct_den)

        def k11_lib():
            return du_lib(), dx_lib()

        library = (k10_lib, k11_lib)
        parts = [device_ms(f, reps=TIMED_CALLS) for f in (du_lib, dx_lib)]
        if None not in parts:
            print(f"[kernels] dual_gather library @ {shape_name}: du "
                  f"(sampled_addmm) {parts[0]:.4f} ms + dx (sparse.mm of "
                  f"the transpose) {parts[1]:.4f} ms = "
                  f"{parts[0] + parts[1]:.4f} ms", flush=True)
    cases = (
        ("dual_scatter" + tag, "num, den",
         lambda: K.dual_scatter(*csr, u, x, pieces=g.scatter_pieces),
         lambda: K.dual_scatter_plain(*csr, u, x), scatter_work, None,
         library[0]),
        ("dual_gather" + tag, "du, dx" if g.rev is not None
         else "du; dx by K1 over CSC", gather,
         lambda: K.dual_gather_plain(*csr, u, x, ct_num, ct_den),
         gather_work, gather64, library[1]),
    )
    dims = f"N={n} E={nv} D={d} H={h}{tag}"
    rows = [time_case(kname, what, shape_name, dims, kern, plain, work,
                      library=lib, reference=ref, timed=timed)
            for kname, what, kern, plain, work, ref, lib in cases]
    for kname, _, kern, _, _, _, _ in cases:
        first, again = kern(), kern()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{kname} @ {shape_name}: two launches "
                                 f"differ")
    print(f"[kernels] dual_scatter, dual_gather{tag} @ {shape_name} H={h}: "
          f"two launches bit-identical in every output", flush=True)
    return rows


def check_norm1_kernels(shape_name, g, d, att, h, score, seed, timed=True,
                        dev="cuda", payload=None, row_bf16=False,
                        multi_rows=False):
    """K12 (both modes), K13 and K14 (every output, against the plain
    version in float64) against their plain versions; two launches of each
    must be bit-identical. ``timed=False`` only compares; ``multi_rows``
    asserts that the row pieces cut some row into several, so that the
    merge passes of K12, K13 and K14 run.

    ``payload=torch.bfloat16`` (the JAX package's bf16 payload, the only
    mode its norm-1 kernels run in) checks them on the bf16 tables, named
    "<kernel> bf16": the column table is x cast to bfloat16, its k table
    rounded as the package rounds k_e, beside the row side x, float32 or
    (``row_bf16``, the bf16 ODE state) x itself in bfloat16; K14's plain
    version is evaluated in float64 beside the same bfloat16 table."""
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    g, randn, csr, ops, kw_f = rhs_operands(g, d, att, h, score, seed, dev)
    bf16 = payload == torch.bfloat16
    if row_bf16:
        ops = (ops[0].to(torch.bfloat16),) + ops[1:]
    kw_x = dict(xcol=ops[0].to(torch.bfloat16)) if bf16 else {}
    n, nv = g.num_nodes, g.num_valid
    ct_ax = randn(n, d)
    # den's cotangent positive, as in check_fused_kernels
    ct_den = 1.0 + randn(n, h, scale=0.1)
    kw_p = dict(pieces=g.row_pieces)
    recip = (1.0 / (K.norm1_den(*csr, *ops, **kw_p, **kw_x, **kw_f) + 1e-16)
             ).contiguous()
    cts = (ct_ax, (recip / h).contiguous(), ct_den)

    def f64(t):
        return (t.double() if torch.is_tensor(t) and t.is_floating_point()
                and t.dtype != torch.bfloat16 else t)

    def den64(**extra):
        kw = {k: f64(v) for k, v in {**kw_x, **kw_f, **extra}.items()}
        return K.norm1_den_plain(*csr, *map(f64, ops), **kw).float()

    def bwd64():
        kw = {k: f64(v) for k, v in {**kw_x, **kw_f}.items()}
        out = K.norm1_bwd_plain(*csr, *map(f64, ops), *map(f64, cts), **kw)
        return tuple(o.float() for o in out if o is not None)

    def some(out):
        return tuple(o for o in out if o is not None)

    # compulsory bytes and float32 operations as in check_fused_kernels:
    # indices, the row side x and the column table (one tensor but for a
    # float32 row side beside the bf16 payload; a bf16 element 2 bytes)
    # and the projections' weights; every node's q and k projections, per
    # edge one score (K14: two, and their derivatives) and the dot products
    # or accumulations over D
    x_bytes = ops[0].element_size() * n * d
    if bf16 and not row_bf16:
        x_bytes += 2 * n * d
    base_bytes = 4 * (n + 1 + nv + 2 * d * att + 2 * att) + x_bytes
    proj = projection_ops(d, att, score)
    cases = [
        ("norm1_den", "column denominators",
         lambda: K.norm1_den(*csr, *ops, **kw_p, **kw_x, **kw_f),
         lambda: K.norm1_den_plain(*csr, *ops, **kw_x, **kw_f),
         (base_bytes + 4 * n * h, 2 * n * proj + nv * 2 * att), den64),
        ("norm1_den", "weighted by ct[c] . x[n]",
         lambda: K.norm1_den(*csr, *ops, ct=ct_ax, **kw_p, **kw_x, **kw_f),
         lambda: K.norm1_den_plain(*csr, *ops, ct=ct_ax, **kw_x, **kw_f),
         (base_bytes + 4 * n * (d + h),
          2 * n * proj + nv * (2 * att + 2 * d)),
         lambda: den64(ct=ct_ax)),
        ("norm1_fwd", "ax",
         lambda: K.norm1_fwd(*csr, *ops, recip, pieces=g.row_pieces, **kw_x,
                             **kw_f),
         lambda: K.norm1_fwd_plain(*csr, *ops, recip, **kw_x, **kw_f),
         (base_bytes + 4 * n * (h + d),
          2 * n * proj + nv * (2 * att + 2 * d + 2 * h)), None),
        ("norm1_bwd", "dq, dxrow, dkw, dkb, dgmax[, dvar, dls]",
         lambda: some(K.norm1_bwd(*csr, *ops, *cts, pieces=g.row_pieces,
                                  **kw_x, **kw_f)),
         lambda: some(K.norm1_bwd_plain(*csr, *ops, *cts, **kw_x, **kw_f)),
         (base_bytes + 4 * (n * (d + 2 * h) + n * att + n * d + d * att),
          4 * n * proj + nv * (10 * att + 6 * d)), bwd64),
    ]
    tag = ""
    if bf16:
        cases = [(kname + " bf16", *c) for kname, *c in cases]
        tag = " row bf16" if row_bf16 else " bf16"
    dims = f"N={n} E={nv} D={d} ATT={att} H={h} {score}{tag}"
    print_walk_design("norm1_den", shape_name, dims, g, d, att, h, score,
                      multi_rows)
    print_walk_design("norm1_fwd", shape_name, dims, g, d, att, h, score,
                      multi_rows)
    print_walk_design("norm1_bwd", shape_name, dims, g, d, att, h, score)
    rows = [time_case(kname, what, shape_name, dims, kern, plain, work,
                      reference=ref, timed=timed)
            for kname, what, kern, plain, work, ref in cases]
    for kname, what, kern, _, _, _ in cases:
        first, again = kern(), kern()
        if torch.is_tensor(first):
            first, again = (first,), (again,)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{kname} ({what}) {score} @ {shape_name}: "
                                 f"two launches differ")
    print(f"[kernels] norm1_den, norm1_fwd, norm1_bwd @ {shape_name} "
          f"{score}{tag}: two launches bit-identical in every output",
          flush=True)
    return rows


def check_blocked_kernels(shape_name, g, d, seed, block_n=1024, chunk=1024,
                          dev="cuda"):
    """K15 forward, K15 on the transposed plan (dx, weights permuted with
    t_perm) and K16 against their plain versions, over the block plan of a
    prepared graph's valid edges; two launches of each must be
    bit-identical. Then K1 and K2 on the same row-sorted graph, so that the
    two layouts are timed side by side."""
    import torch
    from graph_neural_pde_tpu_torch import kernels as K
    from graph_neural_pde_tpu_torch.kernels.blocked import (blocked_layout,
                                                            make_plan_pair)
    from graph_neural_pde_tpu_torch.ops.reorder import plan_occupancy
    dev = torch.device(dev)
    nv = g.num_valid
    plans = make_plan_pair(g.row[:nv].numpy(), g.col[:nv].numpy(),
                           num_nodes=g.num_nodes, block_n=block_n,
                           chunk=chunk)
    fwd, bwd = blocked_layout(plans.fwd, dev), blocked_layout(plans.bwd, dev)
    npad, cap = fwd.num_nodes, fwd.capacity
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((npad, d), generator=gen, device=dev)
    ct = torch.randn((npad, d), generator=gen, device=dev)
    # positive weights on the valid slots, 0 on padding, as the engine
    # hands K15 the frozen attention
    w = torch.rand((cap,), generator=gen, device=dev) * fwd.valid
    t_valid = torch.as_tensor(plans.t_valid, device=dev)
    w_t = torch.where(t_valid, w[torch.as_tensor(plans.t_perm, device=dev)
                                 .long()], torch.zeros((), device=dev))
    # the yardsticks: one PyTorch call each, used nowhere in the port
    vrows = torch.as_tensor(plans.fwd.row[plans.fwd.valid], device=dev)
    vcols = torch.as_tensor(plans.fwd.col[plans.fwd.valid], device=dev)
    idx = torch.stack([vrows.long(), vcols.long()])
    csr = torch.sparse_coo_tensor(idx, w[fwd.valid], (npad, npad)) \
        .coalesce().to_sparse_csr()
    pattern = torch.sparse_coo_tensor(
        idx, torch.ones(idx.shape[1], device=dev), (npad, npad)) \
        .coalesce().to_sparse_csr()
    # dx = A^T ct: the same matrix transposed, weights unpermuted
    csr_t = torch.sparse_coo_tensor(idx.flip(0), w[fwd.valid], (npad, npad)) \
        .coalesce().to_sparse_csr()
    x_t = x.t().contiguous()
    nslots = int(plans.fwd.valid.sum())
    # K15 reads per valid slot its slot index, its column and its weight,
    # x once, and writes out; K16 reads two local ids per slot, both
    # tables, and writes one float per slot (padding included); 2 flop per
    # slot and feature
    spmm_work = (4 * (3 * nslots + 2 * npad * d), 2 * nslots * d)
    dot_work = (4 * (3 * cap + 2 * npad * d), 2 * cap * d)
    cases = (
        ("blocked_spmm", "forward A_w x",
         lambda: K.blocked_spmm(fwd, w, x),
         lambda: K.blocked_spmm_plain(fwd, w, x), spmm_work,
         lambda: torch.sparse.mm(csr, x)),
        ("blocked_spmm", "backward dx, transposed plan",
         lambda: K.blocked_spmm(bwd, w_t, ct),
         lambda: K.blocked_spmm_plain(bwd, w_t, ct), spmm_work,
         lambda: torch.sparse.mm(csr_t, ct)),
        ("blocked_sddmm", "backward dw = ct[row].x[col]",
         lambda: K.blocked_sddmm(fwd, ct, x),
         lambda: K.blocked_sddmm_plain(fwd, ct, x), dot_work,
         lambda: torch.sparse.sampled_addmm(pattern, ct, x_t, beta=0.0)),
    )
    occ = plan_occupancy(plans.fwd)
    dims = (f"N={g.num_nodes} N_pad={npad} slots={nslots} cap={cap} D={d} "
            f"B={block_n} buckets={occ['buckets']}")
    print_lanes("blocked_sddmm", shape_name, d, ct, x)
    rows = [time_case(kname, what, shape_name, dims, kern, plain, work,
                      library)
            for kname, what, kern, plain, work, library in cases]
    for kname, what, kern, _, _, _ in cases:
        if not torch.equal(kern(), kern()):
            raise AssertionError(f"{kname} ({what}) @ {shape_name}: two "
                                 f"launches differ")
    print(f"[kernels] blocked_spmm, blocked_sddmm @ {shape_name}: plan fill "
          f"{occ['fill']:.3f} over {occ['n_chunks']} chunks; two launches "
          f"bit-identical", flush=True)
    return rows + check_kernels(shape_name, g, d, seed, dev=dev)


def grand_nl_cora():
    """The tuned Cora row as GRAND-nl: attention recomputed at every RHS
    evaluation (transformer function over the constant block) with the row
    softmax that the fused kernels take."""
    from graph_neural_pde_tpu_torch.config import best_params
    return best_params["Cora"].replace(
        function="transformer", block="constant", attention_norm_idx=0,
        square_plus=False)


def attention_layer(model):
    """The attention layer whose parameters decide the model's attention
    (Q and K, or the GAT function's W and a)."""
    func_att = getattr(model.block.func, "att", None)
    return func_att if func_att is not None else model.block.att


# the bf16 payload's logits in check_small_end_to_end: the largest gap
# between the card and the CPU, of the largest logit
BF16_LOGITS = 3e-4
# the softmax over columns under the bf16 payload: the card's and the CPU's
# float32 states differ in their last bits, each such difference flips a
# bf16 rounding of x[col] now and then (2^-8 of an element), and attention
# normalised over columns, not row-stochastic, grows what a flip moves. On
# an H100 the Cora GRAND-nl row measured 5.632e-4 of scale, each side
# bit-identical on rerun, where the float32 payload lies 1.281e-3 away; its
# gradient leaves 9.037e-4 of their scale at most (the float32 payload's
# 2.436e-3), and the same flips leave every gradient entry a noise of up to
# 2.9e-5 of the largest gradient (m1.w; alpha_train's, whose own scale is
# 2.9e-4 of the largest, 8.8e-6 of it): the rounding noise allowed in
# every entry there (check_small_end_to_end's grad_floor)
BF16_COLUMN_LOGITS = 1e-3
BF16_COLUMN_LEAF = 2e-3
BF16_COLUMN_FLOOR = 1e-4
# the same under the bf16 fixed-grid state, whose every stage sum rounds to
# bfloat16: one bf16 step (2^-8) of the logits' scale, and of each
# gradient leaf's; a rounding that flips between the two devices' float32
# sums moves a state element by one step
BF16_STATE_STEP = 2.0 ** -8


# the CPU ops of the frozen attention (models/attention.py's
# frozen_mean_attention) that ForwardRecorder records, each by its module
# and name: the projections, the scores of the gathered q[row] and k[col]
# rows (inputs too), squareplus's global maximum and the segment
# normalisation (K3's plain version on the CPU), in call order
ATTENTION_OPS = (("attention", "query_key"), ("attention", "edge_scores"),
                 ("scatter", "global_max"), ("scatter", "segment_normalize"))


class ForwardRecorder:
    """Records what a model's forward computes on its way, while entered:
    the encoder's output (the block's input), every call of the frozen
    attention's ops (``ATTENTION_OPS``: each call's tensor inputs and
    outputs), the frozen attention that ``models.blocks.build_aux`` hands
    the solve, every right-hand-side evaluation of the solver (its time,
    state and output, in the solver's order: the stages of every trial
    step) and the block's output, each copied to the host; and the
    prepared graph's views (every tensor attribute of ``model.graph``) as
    they stand when the forward begins. ``compare_forwards`` says where
    two recorded forwards first part."""

    def __init__(self, model):
        self.model = model
        self.record = None

    def __enter__(self):
        import torch
        from graph_neural_pde_tpu_torch.models import attention, blocks, gnn
        from graph_neural_pde_tpu_torch.ops import scatter
        rec = self.record = {"graph": graph_views(self.model.graph),
                             "attention": [], "stages": [], "ops": []}
        self._saved = (blocks.build_aux, blocks.odeint, gnn.block_forward)
        build_aux, odeint, block_forward = self._saved
        modules = {"attention": attention, "scatter": scatter}
        self._ops = [(modules[m], name, getattr(modules[m], name))
                     for m, name in ATTENTION_OPS]

        def host(t):
            return t.detach().to("cpu", copy=True)

        def tensors(v):
            if isinstance(v, (tuple, list)):
                return [t for x in v for t in tensors(x)]
            return [host(v)] if isinstance(v, torch.Tensor) else []

        def recorded(name, fn):
            def op(*a, **kw):
                out = fn(*a, **kw)
                rec["ops"].append((name, tensors(a), tensors(out)))
                return out
            return op

        for mod, name, fn in self._ops:
            setattr(mod, name, recorded(name, fn))

        def rec_build_aux(*a, **kw):
            aux, keep = build_aux(*a, **kw)
            if aux.attention is not None:
                rec["attention"].append(host(aux.attention))
            return aux, keep

        def rec_odeint(func, y0, *a, **kw):
            def rec_func(t, y):
                out = func(t, y)
                rec["stages"].append((float(t), host(y), host(out)))
                return out
            return odeint(rec_func, y0, *a, **kw)

        def rec_block_forward(block, cfg, g, x, *a, **kw):
            rec["block_in"] = host(x)
            z, stats = block_forward(block, cfg, g, x, *a, **kw)
            rec["block_out"] = host(z)
            return z, stats

        blocks.build_aux, blocks.odeint = rec_build_aux, rec_odeint
        gnn.block_forward = rec_block_forward
        return self

    def __exit__(self, *exc):
        from graph_neural_pde_tpu_torch.models import blocks, gnn
        blocks.build_aux, blocks.odeint, gnn.block_forward = self._saved
        for mod, name, fn in self._ops:
            setattr(mod, name, fn)
        return False


def graph_views(g) -> dict:
    """Every tensor a prepared graph holds (its CSR, the CSC view, the
    reverse-edge map, the row and column pieces), copied to the host."""
    import torch
    views = {}
    for name, v in sorted(vars(g).items()):
        if torch.is_tensor(v):
            views[name] = v.detach().to("cpu", copy=True)
        elif hasattr(v, "__dict__"):
            for sub, t in sorted(vars(v).items()):
                if torch.is_tensor(t):
                    views[f"{name}.{sub}"] = t.detach().to("cpu", copy=True)
    return views


def compare_forwards(label: str, a: dict, b: dict, names=("a", "b")):
    """Prints where the recorded forwards ``a`` and ``b`` first part: the
    graph views they read, the block's input, the frozen attention, each
    solver stage's time, state and output (the first stage that differs
    and the largest gaps), the block's output. Returns the lines."""
    lines = []

    def gap(x, y):
        if x.shape != y.shape:
            return f"shapes {tuple(x.shape)} vs {tuple(y.shape)}"
        if x.dtype.is_floating_point:
            d = float((x.double() - y.double()).abs().max()) if x.numel() \
                else 0.0
            return None if d == 0.0 else f"{d:.3e}"
        return None if torch_equal(x, y) else "differ"

    for k in sorted(set(a["graph"]) | set(b["graph"])):
        if k not in a["graph"] or k not in b["graph"]:
            lines.append(f"graph view {k} only in one forward")
            continue
        g_ = gap(a["graph"][k], b["graph"][k])
        if g_:
            lines.append(f"graph view {k}: {g_}")
    for k in ("block_in", "block_out"):
        if k in a and k in b:
            lines.append(f"{k}: {gap(a[k], b[k]) or 'bit-identical'}")
    oa, ob = a.get("ops", []), b.get("ops", [])
    lines.append(f"attention ops: {len(oa)} vs {len(ob)} calls")
    for i, ((na, ia, ra), (nb, ib, rb)) in enumerate(zip(oa, ob)):
        gi = [gap(x, y) for x, y in zip(ia, ib)]
        go = [gap(x, y) for x, y in zip(ra, rb)]
        if na != nb or any(gi) or any(go):
            lines.append(f"first attention op that differs: call {i} "
                         f"{na} vs {nb}: inputs "
                         f"{[g_ or '=' for g_ in gi]}, outputs "
                         f"{[g_ or '=' for g_ in go]}")
            break
    else:
        if oa:
            lines.append("every attention op call bit-identical")
    for i, (x, y) in enumerate(zip(a["attention"], b["attention"])):
        lines.append(f"frozen attention {i}: {gap(x, y) or 'bit-identical'}")
    sa, sb = a["stages"], b["stages"]
    lines.append(f"solver stages: {len(sa)} vs {len(sb)}")
    first = None
    for i, ((ta, ya, oa), (tb, yb, ob)) in enumerate(zip(sa, sb)):
        gy, go = gap(ya, yb), gap(oa, ob)
        if ta != tb or gy or go:
            if first is None:
                first = i
                lines.append(f"first stage that differs: {i} at t {ta!r} vs "
                             f"{tb!r}: state {gy or 'bit-identical'}, output "
                             f"{go or 'bit-identical'}")
            elif i - first < 8 or i == len(sa) - 1:
                lines.append(f"stage {i} t {ta:.6g}: state {gy or '='}, "
                             f"output {go or '='}")
    if first is None:
        lines.append("every solver stage bit-identical")
    for line in lines:
        print(f"[small] {label} {names[0]} vs {names[1]}: {line}", flush=True)
    return lines


def torch_equal(x, y) -> bool:
    import torch
    return bool(torch.equal(x, y))


def check_small_end_to_end(row: str, base=None, devices=("cpu", "cuda"),
                           early_stop_counts: bool = True,
                           grad_floor: float = 1e-6, graph=None,
                           pos_dim: int = 0):
    """A tuned row (or ``base``) at reduced width on a 300-node SBM (over
    ``graph`` where one is given: a rewired edge list built once and handed
    to both devices): the card's kernel path against the CPU's plain path,
    same weights and inputs. A ``beltrami`` config runs at widths 12 + 4
    with a seeded N(0, 1) positional encoding of width ``pos_dim``. The
    early-stop eval integrates to 3T, far into the steady state, where the
    error estimate is rounding noise: a config whose step counts differ
    there between two orders of summation passes
    ``early_stop_counts=False`` and is held to the best snapshot instead
    (equal validation accuracy, t* within 1%). ``grad_floor`` is the
    rounding noise allowed in every gradient entry, as a share of the
    largest gradient.

    A config with the bfloat16 payload holds its logits within
    ``BF16_LOGITS`` of their largest entry, and its loss and gradients as
    above (over columns ``BF16_COLUMN_LOGITS``, and each gradient leaf
    within ``BF16_COLUMN_LEAF`` of its scale); with the bfloat16 state too (``dtype="bfloat16"``), its logits
    and each gradient leaf within ``BF16_STATE_STEP`` of their scale. It
    runs on a
    fixed grid (rk4, the mode's route in the bench): on an
    adaptive one the error estimate is bf16 rounding noise, so the step
    sequence, and with it every gradient, hangs on the last bits of the
    two devices' float32 sums. The card's side must have launched the
    kernels' bfloat16 mode (K1; K6 and K9; with ``sym_backward=False``,
    K6, K8 and K17; over columns K12-K14; squareplus and GAT K10 and K11),
    and the check prints the
    largest gaps of the logits, the loss and each gradient leaf (of its own
    scale) beside those of the CPU's float32-payload run, the control that
    says the tolerances tell the two modes apart."""
    import torch
    from graph_neural_pde_tpu_torch import kernels
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
    from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
    from graph_neural_pde_tpu_torch.solvers.api import FIXED_METHODS
    from graph_neural_pde_tpu_torch.training.train import cross_entropy_loss
    cfg = (base or best_params[row]).replace(
        hidden_dim=16, attention_dim=16, heads=4, input_dropout=0.0,
        dropout=0.0, feat_hidden_dim=12, pos_enc_hidden_dim=4)
    d = make_sbm_dataset(num_nodes=300, num_classes=4, num_features=24,
                         seed=3, num_val=60)
    if graph is not None:
        d.graph = graph
    gen = torch.Generator().manual_seed(5)
    pos = (torch.randn(300, pos_dim, generator=torch.Generator()
                       .manual_seed(6)) if cfg.beltrami else None)
    results, models, records = {}, {}, {}
    state = None
    # the inputs as they came, to tell on a failure whether a run moved them
    inputs0 = (d.x.clone(), d.graph.weight.clone())
    bf16 = cfg.rhs_payload_dtype == "bfloat16" or cfg.dtype == "bfloat16"
    state_bf16 = cfg.dtype == "bfloat16" and cfg.method in FIXED_METHODS
    logits_limit = (BF16_STATE_STEP if state_bf16 else BF16_COLUMN_LOGITS
                    if cfg.attention_norm_idx == 1 else BF16_LOGITS)
    bf16_ran = {}
    for dev in devices:
        before = {k.__name__: k.bf16_launches for k in kernels.BF16_KERNELS}
        before[ROWS] = kernels.fused_rhs_bwd.bf16_rows_launches
        m = GNNEarlyModel(cfg, 24, 4, d.graph, device=dev,
                          pos_enc_dim=pos_dim)
        if state is None:
            # random Q/K (BLEND: Qx, Kx, Qp, Kp) so the attention is not
            # uniform (the GAT layer's W and a are drawn at random already)
            with torch.no_grad():
                att = attention_layer(m)
                for name in ("Q", "K", "Qx", "Kx", "Qp", "Kp"):
                    if hasattr(att, name):
                        lin = getattr(att, name)
                        lin.w.copy_(0.3 * torch.randn(lin.w.shape,
                                                      generator=gen))
            state = {k: v.cpu().clone() for k, v in m.state_dict().items()}
        m.load_state_dict(state)
        x, y = d.x.to(dev), d.y.to(dev)
        pe = pos.to(dev) if pos is not None else None
        masks = tuple(t.to(dev) for t in (d.train_mask, d.val_mask,
                                          d.test_mask))
        # the first forward's intermediates, kept for the diagnostic below
        with ForwardRecorder(m) as recorder:
            logits, stats = m(x, training=True, pos_encoding=pe)
        records[dev] = recorder.record
        loss = cross_entropy_loss(logits, y, masks[0])
        loss.backward()
        _, best, es_stats = m.apply_early(x, y, masks, pe)
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()
                 if p.grad is not None}
        results[dev] = (logits.detach().cpu(), float(loss.detach()), stats, best,
                        es_stats, grads)
        bf16_ran[dev] = {k.__name__: k.bf16_launches - before[k.__name__]
                         for k in kernels.BF16_KERNELS}
        bf16_ran[dev][ROWS] = (kernels.fused_rhs_bwd.bf16_rows_launches
                               - before[ROWS])
        models[dev] = m
    (lc, loss_c, st_c, best_c, es_c, g_c) = results[devices[0]]
    (lg, loss_g, st_g, best_g, es_g, g_g) = results[devices[1]]
    es_counts = ("accepted", "rejected", "nfe")
    counts = es_counts + (("bwd_accepted", "bwd_rejected", "bwd_nfe")
                          if cfg.adjoint else ())
    if [st_c[k] for k in counts] != [st_g[k] for k in counts]:
        raise AssertionError(f"solver steps differ: cpu {st_c} cuda {st_g}")
    if bf16:
        if cfg.method not in FIXED_METHODS:
            raise ValueError(f"{row}: the bf16 check runs on a fixed grid")
        if torch.device(devices[1]).type == "cuda":
            # the card's side went through the kernels' bfloat16 mode
            if cfg.function == "laplacian":
                need = ("csr_spmm",)
            elif cfg.attention_norm_idx == 1:
                need = NORM1_KERNELS
            elif cfg.function == "GAT" or cfg.square_plus:
                need = ("dual_scatter", "dual_gather")
            elif cfg.sym_backward is False:
                need = COLPLAN_KERNELS
            else:
                need = ("fused_rhs_fwd", "fused_rhs_bwd_sym")
            ran = bf16_ran[devices[1]]
            if not all(ran[k] > 0 for k in need):
                raise AssertionError(f"{row}: the bfloat16 kernels {need} "
                                     f"did not all run on {devices[1]}: "
                                     f"{ran}")
        print_bf16_gaps(row, cfg, d, state, pos, pos_dim, lc, loss_c, g_c,
                        lg, loss_g, g_g)
    if early_stop_counts:
        if [es_c[k] for k in es_counts] != [es_g[k] for k in es_counts]:
            raise AssertionError(f"early-stop steps differ: {es_c} vs {es_g}")
    elif not (best_c.val == best_g.val and math.isclose(
            best_c.time, best_g.time, rel_tol=1e-2)):
        raise AssertionError(f"early-stop best differs: cpu {best_c} vs "
                             f"cuda {best_g}")
    if bf16:
        # a bf16 rounding that flips between the two devices' float32 sums
        # moves small logits as much as large ones: held at the logits'
        # scale instead of elementwise, between the noise and the float32
        # payload (on an H100: 7.8e-6 of scale on the tuned Cora row, as
        # far as the CPU's float64 run, and 6.6e-5 on Cora GRAND-nl; the
        # float32 payload's logits 1.3e-3 and 1.8e-3 of scale away)
        close = (float((lg - lc).abs().max())
                 <= logits_limit * float(lc.abs().max()))
    else:
        close = torch.allclose(lg, lc, rtol=1e-4, atol=1e-5)
    if not close:
        # say which side moved before raising: rerun both and a float64
        # CPU run from the same weights (training-mode forwards)
        def forward_logits(dev, dtype=torch.float32, grad=False, m=None):
            if m is None:
                m = GNNEarlyModel(cfg, 24, 4, d.graph, device=dev,
                                  pos_enc_dim=pos_dim)
                m.load_state_dict(state)
                m = m.to(dtype)
            pe = None if pos is None else pos.to(dev, dtype)
            with torch.set_grad_enabled(grad):
                out, st = m(d.x.to(dev, dtype), training=True,
                            pos_encoding=pe)
            print(f"[small] {row} rerun on {dev} {dtype} (autograd {grad}): "
                  f"steps {dict((k, st[k]) for k in counts)}", flush=True)
            return out.detach().cpu().double()

        print(f"[small] {row}: the inputs moved by "
              f"{float((d.x - inputs0[0]).abs().max()):.3e} (x), "
              f"{float((d.graph.weight - inputs0[1]).abs().max()):.3e} "
              f"(edge weights) since the check began", flush=True)
        # the check's own CPU model object again, its intermediates
        # recorded: where does it part from the first forward, and where
        # from the card's?
        with ForwardRecorder(models[devices[0]]) as recorder:
            again = forward_logits("cpu", grad=True, m=models[devices[0]])
        compare_forwards(row, records[devices[0]], recorder.record,
                         ("first cpu forward", "cpu model again"))
        compare_forwards(row, records[devices[0]], records[devices[1]],
                         ("first cpu forward", "first cuda forward"))
        dump = os.path.join("chiprun_out", "small_check_"
                            + "".join(ch if ch.isalnum() else "_"
                                      for ch in row)
                            + f"_{os.getpid()}.pt")
        os.makedirs(os.path.dirname(dump), exist_ok=True)
        torch.save({"first cpu forward": records[devices[0]],
                    "cpu model again": recorder.record,
                    "first cuda forward": records[devices[1]]}, dump)
        print(f"[small] {row}: the three forwards' intermediates in {dump}",
              flush=True)
        runs = {"cpu": lc.double(), "cuda": lg.double(),
                "cpu rerun": forward_logits("cpu"),
                "cpu rerun with autograd": forward_logits("cpu", grad=True),
                "cpu model of the check again": again,
                "cuda rerun": forward_logits(devices[1])}
        if not bf16 or cfg.function == "laplacian":
            # the fused kernels' plain versions take no float64 row side
            # beside a bfloat16 column table
            runs["cpu float64"] = forward_logits("cpu", torch.float64)
        names = list(runs)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                print(f"[small] {row} logits: {a} vs {b} differ by "
                      f"{float((runs[a] - runs[b]).abs().max()):.3e}",
                      flush=True)
        raise AssertionError(
            f"logits differ between cuda and cpu by "
            f"{float((lg - lc).abs().max()):.3e} (largest logit "
            f"{float(lc.abs().max()):.3e})")
    if not math.isclose(loss_g, loss_c, rel_tol=1e-4):
        raise AssertionError(f"loss cuda {loss_g} vs cpu {loss_c}")
    # a leaf whose true gradient is 0 (K's bias under a row softmax) holds
    # only rounding noise: grad_floor of the largest gradient is allowed
    # everywhere
    top = max(float(v.abs().max()) for v in g_c.values())
    leaf_atol = (BF16_STATE_STEP if state_bf16 else BF16_COLUMN_LEAF
                 if bf16 and cfg.attention_norm_idx == 1 else 1e-4)
    for k in g_c:
        scale = float(g_c[k].abs().max())
        if not torch.allclose(g_g[k], g_c[k], rtol=1e-3,
                              atol=leaf_atol * scale + grad_floor * top):
            raise AssertionError(
                f"gradient {k} differs between cuda and cpu by "
                f"{float((g_g[k] - g_c[k]).abs().max()):.3e} (leaf scale "
                f"{scale:.3e}, largest gradient {top:.3e})")
    print(f"[small] {row} cuda vs cpu: loss {loss_g:.6f} vs {loss_c:.6f}, "
          f"steps {dict((k, st_g[k]) for k in counts)}, early-stop best val "
          f"{best_g.val:.4f} vs {best_c.val:.4f} at t* {best_g.time:.4f} vs "
          f"{best_c.time:.4f}: agree (logits "
          f"{f'{logits_limit:g} of scale' if bf16 else 'rtol 1e-4'}, grads "
          f"rtol 1e-3)",
          flush=True)


def print_bf16_gaps(row, cfg, d, state, pos, pos_dim, lc, loss_c, g_c, lg,
                    loss_g, g_g):
    """The bf16 check's readings: the largest gaps between the card and the
    CPU (logits and each gradient leaf of its own scale, the loss
    relative), and the same gaps between the card and the CPU's run of the
    float32 payload from the same weights, the control. Leaves under 1e-3
    of the largest gradient are left out of the reading."""
    import torch
    from graph_neural_pde_tpu_torch.models.gnn_early import GNNEarlyModel
    from graph_neural_pde_tpu_torch.training.train import cross_entropy_loss
    m = GNNEarlyModel(cfg.replace(rhs_payload_dtype="float32",
                                  dtype="float32"), 24, 4, d.graph,
                      device="cpu", pos_enc_dim=pos_dim)
    m.load_state_dict(state)
    l32, _ = m(d.x, training=True, pos_encoding=pos)
    loss32 = cross_entropy_loss(l32, d.y, d.train_mask)
    loss32.backward()
    g32 = {k: p.grad.detach() for k, p in m.named_parameters()
           if p.grad is not None}

    top = max(float(v.abs().max()) for v in g_c.values())

    def gaps(logits, loss, grads):
        # the leaves that are zero to rounding (K's bias under a row
        # softmax) are held at grad_floor of the largest gradient instead
        per_leaf = {k: float((g_g[k] - grads[k]).abs().max())
                    / float(grads[k].abs().max()) for k in grads
                    if float(g_c[k].abs().max()) > 1e-3 * top}
        worst = max(per_leaf, key=per_leaf.get)
        lgap = float((lg - logits).abs().max()) / float(logits.abs().max())
        return (f"logits {lgap:.3e} of scale, loss "
                f"{abs(loss_g - loss) / abs(loss):.3e}, "
                f"largest leaf {per_leaf[worst]:.3e} of its scale ({worst})")

    print(f"[small] {row}, the card against the CPU: "
          f"{gaps(lc, loss_c, g_c)}; against the CPU's float32 payload "
          f"(control): {gaps(l32.detach(), float(loss32), g32)}", flush=True)


def check_small_image(engine: str, devices=("cpu", "cuda")):
    """The image model (12 x 12 stand-in images, batch 8, the image CLI's
    rk4 solve) card against CPU from the same weights: one training
    forward and backward on ``engine`` ("xla" or "pallas_blocked" with
    128-node blocks)."""
    import torch
    from graph_neural_pde_tpu_torch.data.image import load_image_dataset
    from graph_neural_pde_tpu_torch.models.gnn_image import GNNImageModel
    from graph_neural_pde_tpu_torch.training.train import cross_entropy_loss
    cfg = image_config(spmm_impl=engine, spmm_block_n=128, spmm_chunk=128)
    data = load_image_dataset(tempfile.gettempdir(), "MNIST", 8)
    x, y = next(data.batches(seed=0))
    results, state = [], None
    for dev in devices:
        m = GNNImageModel(cfg, data.graph, data.h, data.w, data.c, 4, 8,
                          device=dev)
        if state is None:
            with torch.no_grad():
                m.block.func.alpha_train.fill_(0.7)
                m.block.func.beta_train.fill_(-0.4)
            state = {k: v.cpu().clone() for k, v in m.state_dict().items()}
        m.load_state_dict(state)
        logits, stats = m(torch.from_numpy(x).to(dev), training=True)
        loss = cross_entropy_loss(logits, torch.from_numpy(y).to(dev),
                                  torch.ones(8, device=dev))
        loss.backward()
        results.append((logits.detach().cpu(), float(loss.detach()),
                        {k: p.grad.cpu() for k, p in m.named_parameters()
                         if p.grad is not None}, stats["nfe"]))
    (lc, loss_c, g_c, nfe_c), (lg, loss_g, g_g, nfe_g) = results
    if nfe_c != nfe_g or not torch.allclose(lg, lc, rtol=1e-4, atol=1e-5) \
            or not math.isclose(loss_g, loss_c, rel_tol=1e-4):
        raise AssertionError(f"image model {engine}: cuda and cpu differ "
                             f"(logits by {float((lg - lc).abs().max()):.3e},"
                             f" loss {loss_g} vs {loss_c}, nfe {nfe_g} vs "
                             f"{nfe_c})")
    for k in g_c:
        if not torch.allclose(g_g[k], g_c[k], rtol=1e-3,
                              atol=1e-4 * float(g_c[k].abs().max())):
            raise AssertionError(f"image model {engine}: gradient {k} "
                                 f"differs between cuda and cpu")
    print(f"[small] image model {engine} cuda vs cpu: loss {loss_g:.6f} vs "
          f"{loss_c:.6f}, nfe {nfe_g}: agree (logits rtol 1e-4, grads rtol "
          f"1e-3)", flush=True)


def small_gdc_graph():
    """check_small_end_to_end's 300-node SBM rewired by GDC at the CLI's
    defaults (approximate PPR, top 64 per column, self loop weight 1), the
    dense diffusion on the card: a host graph, directed."""
    from graph_neural_pde_tpu_torch.config import Config
    from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
    from graph_neural_pde_tpu_torch.rewiring.gdc import apply_gdc
    d = make_sbm_dataset(num_nodes=300, num_classes=4, num_features=24,
                         seed=3, num_val=60)
    g = apply_gdc(d.graph, Config(self_loop_weight=1.0), device="cuda")
    if g.sort_by_row().rev is not None:
        raise AssertionError("the GDC-rewired SBM is symmetric")
    return g


def check_deepwalk_and_knn(data_dir: str):
    """DeepWalk's skip-gram training (``rewiring.positional.sgns_train``)
    card against CPU from one start on check_small_end_to_end's 300-node
    SBM (12 steps of 65,536 pairs at a rate of 1, so that the embedding
    moves by more than the tolerance: 1e-4 of scale; the gathers' gradient
    is summed in another order on the card), then the ``pos_enc_knn``
    rewiring of that SBM from a DeepWalk encoding computed on the card and
    cached under ``data_dir``, card against CPU (the kNN search on each from
    the same cached encoding: the same edge set). Returns the rewired host
    graph, directed."""
    import numpy as np
    import torch
    from graph_neural_pde_tpu_torch.config import Config
    from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
    from graph_neural_pde_tpu_torch.rewiring import knn, positional
    d = make_sbm_dataset(num_nodes=300, num_classes=4, num_features=24,
                         seed=3, num_val=60)
    m = d.graph.mask.numpy()
    row, col = d.graph.row.numpy()[m], d.graph.col.numpy()[m]
    centers, contexts = positional.skipgram_pairs(
        positional.random_walks(row, col, 300, seed=1), 5)
    init = 0.1 * torch.randn(300, 16, generator=torch.Generator()
                             .manual_seed(1))
    t0 = time.perf_counter()
    on_card = positional.sgns_train(init.cuda(), centers, contexts, 300,
                                    seed=1, lr=1.0)
    secs = time.perf_counter() - t0
    on_cpu = positional.sgns_train(init, centers, contexts, 300, seed=1,
                                   lr=1.0)
    rel = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    moved = float(np.abs(on_cpu - init.numpy()).max()
                  / np.abs(on_cpu).max())
    if not rel < 1e-4 < moved:
        raise AssertionError(f"DeepWalk on the card differs from the CPU by "
                             f"{rel:.3e} of scale (moved {moved:.3e})")
    cfg = Config(dataset="sbm300", pos_enc_type="DW16", gdc_k=8,
                 rewiring="pos_enc_knn", edge_pad_multiple=1)
    graphs = [knn.apply_pos_dist_rewire(d.graph, cfg, data_dir, device=dev)
              for dev in ("cuda", "cpu")]  # the card computes and caches
    edges = [set(zip(g.row.tolist(), g.col.tolist())) for g in graphs]
    if edges[0] != edges[1]:
        raise AssertionError("pos_enc_knn: card and CPU edge sets differ")
    if graphs[0].sort_by_row().rev is not None:
        raise AssertionError("the pos_enc_knn SBM is symmetric")
    print(f"[small] DeepWalk sgns on the card vs cpu: {rel:.3e} of scale "
          f"after 12 steps ({secs:.2f} s on the card, moved {moved:.3e}); "
          f"pos_enc_knn over a DW16 encoding computed on the card: "
          f"{len(edges[0])} edges, card and cpu agree", flush=True)
    return graphs[0]


def drive_image_path(label: str, cfg, data_dir: str, expected):
    """``train_image`` at the image CLI's defaults (batch 64, rk4, step 1,
    T = 3) over the stand-in images for one epoch of four batches, counters
    set to 0 just before and read just after. Returns (history, launch
    counts, peak device memory in GiB)."""
    import torch
    from graph_neural_pde_tpu_torch.training.run_image import train_image
    torch.cuda.reset_peak_memory_stats()
    (_, hist), launches, secs = counted(
        label, expected,
        lambda: train_image(cfg, data_dir, "MNIST", 64, 1, max_batches=4,
                            verbose=False, device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (len(hist) == 1 and math.isfinite(hist[0][0])):
        raise AssertionError(f"{label}: bad history {hist}")
    print(f"[main] 4 batches of {label} in {secs:.2f} s, loss "
          f"{hist[0][0]:.6f}, peak device memory {peak:.4f} GiB; kernel "
          f"launches {launches}", flush=True)
    return hist, launches, peak


def check_shard_kernels(shape_name, g, d, seed, ranks=(0, 3), world=4,
                        dev="cuda", bf16=False):
    """The P6 pair on ranks of a ``world``-way split of ``g``'s row-sorted
    valid edges (``make_sharded_stripe_spmm``'s shards, cut wherever the
    ``np.linspace`` bounds fall, so rows straddle ranks and most of a
    rank's N + 1 row pointers are empty ranges): K1 in table mode (the
    scatter of a random per-edge payload) and K20 ``row_gather`` (its
    gather), against their plain versions, with ``torch.segment_reduce``
    and ``index_select`` as yardsticks; two launches of each bit-identical.
    ``bf16``: the stripe spmm's bfloat16 payload, K1 in table mode over a
    bfloat16 payload (float32 sums; no one PyTorch call sums a bf16 table
    into float32) and K20 writing bfloat16 rows (yardstick ``index_select``
    and the cast), rows "csr_spmm table mode bf16" and "row_gather bf16"."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import (csr_spmm, csr_spmm_plain,
                                                    row_gather,
                                                    row_gather_plain)
    from graph_neural_pde_tpu_torch.parallel import split_mesh
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import stripe_shards
    dev = torch.device(dev)
    shards = stripe_shards(split_mesh(world, dev), g)
    bf = torch.bfloat16
    rows = []
    for r in ranks:
        plan = shards[r].plan
        n, e = plan.num_nodes, plan.n_valid
        gen = torch.Generator(device=dev).manual_seed(seed + r)
        vals = torch.randn((e, d), generator=gen, device=dev)
        table = torch.randn((n, d), generator=gen, device=dev)
        lengths = (plan.rowptr[1:] - plan.rowptr[:-1]).long()
        csr = (plan.rowptr, plan.row, plan.slots, plan.valid)
        # the segment sum reads the row pointer and the payload and writes
        # [N, D] (K1 also reads the slot index and the mask, 8 B an edge,
        # which the function does not need); the gather reads the row
        # pointer and the table and writes [E, D]; no arithmetic but the
        # sum's adds; a bf16 element is 2 bytes
        if bf16:
            vals = vals.to(bf)
            cases = (
                ("csr_spmm table mode bf16", "P6 scatter of a bf16 payload",
                 lambda: csr_spmm(*csr, vals, table=True, n_edges=e),
                 lambda: csr_spmm_plain(*csr, vals),
                 (4 * (n + 1 + n * d) + 2 * e * d, e * d), None,
                 plain64(csr_spmm_plain, *csr, vals)),
                ("row_gather bf16", "P6 gather bf16(table[row])",
                 lambda: row_gather(plan.rowptr, plan.row, table, e,
                                    out_dtype=bf),
                 lambda: row_gather_plain(plan.rowptr, plan.row, table, bf),
                 (4 * (n + 1 + n * d) + 2 * e * d, 0),
                 lambda: torch.index_select(table, 0,
                                            plan.row.long()).to(bf), None))
        else:
            cases = (
                ("csr_spmm", "table mode: P6 scatter",
                 lambda: csr_spmm(*csr, vals, table=True, n_edges=e),
                 lambda: csr_spmm_plain(*csr, vals),
                 (4 * (n + 1 + e * d + n * d), e * d),
                 lambda: torch.segment_reduce(vals, "sum", lengths=lengths),
                 plain64(csr_spmm_plain, *csr, vals)),
                ("row_gather", "P6 gather table[row]",
                 lambda: row_gather(plan.rowptr, plan.row, table, e),
                 lambda: row_gather_plain(plan.rowptr, plan.row, table),
                 (4 * (n + 1 + n * d + e * d), 0),
                 lambda: torch.index_select(table, 0, plan.row.long()),
                 None))
        dims = f"rank {r} of {world} N={n} E={e} D={d}{' bf16' if bf16 else ''}"
        print_lanes("csr_spmm", f"{shape_name} {dims}", d, vals,
                    mean_row=e / n)
        for kname, what, kern, plain, work, library, ref in cases:
            rows.append(time_case(kname, what, shape_name, dims, kern, plain,
                                  work, library, reference=ref))
            if not torch.equal(kern(), kern()):
                raise AssertionError(f"{kname} {what} @ {shape_name} {dims}: "
                                     f"two launches differ")
        print(f"[kernels] csr_spmm (table mode), row_gather @ {shape_name} "
              f"{dims}: two launches bit-identical", flush=True)
    return rows


def check_edge_shard_kernels(shape_name, g, world, d, seed, att=None, h=None,
                             column_sum=False, timed_ranks=(0,),
                             dev="cuda", state_bf16=False):
    """The kernels of the all-reduce schedules on every rank's edge shard
    of a ``world``-way split of ``g`` (``edge_shards``: the rank's slice
    of the padded edge arrays, row-sorted into a sub-graph over all N
    nodes without a reverse-edge map), at the widths path (u) gives them:
    K1's forward (``make_sharded_spmm``) and, with ``column_sum``, its dx
    over the shard's CSC view; with ``att`` and ``h``, K18, K19 and K8's
    per-head mode (``make_sharded_fused_rhs``). Ranks outside
    ``timed_ranks`` are only compared. ``state_bf16``: under the bf16 ODE
    state, as the dispatchers run it, K1 reads x in bfloat16 and K18, K19
    and K8's per-head mode the bfloat16 x and payload x[col]."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import csr_spmm, csr_spmm_plain
    from graph_neural_pde_tpu_torch.parallel import split_mesh
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import edge_shards
    dev = torch.device(dev)
    rows = []
    for r, shard in enumerate(edge_shards(split_mesh(world, dev), g.to(dev))):
        sg, name, timed = shard.graph, f"{shape_name} edge shard {r}/{world}", \
            r in timed_ranks
        n, nv = sg.num_nodes, sg.num_valid
        gen = torch.Generator(device=dev).manual_seed(seed + r)
        x = torch.randn((n, d), generator=gen, device=dev)
        w = torch.rand((sg.capacity,), generator=gen, device=dev) * sg.mask
        xt = x.to(torch.bfloat16) if state_bf16 else x
        csr = torch.sparse_csr_tensor(sg.rowptr, sg.col[:nv], w[:nv],
                                      size=(n, n))
        print_lanes("csr_spmm", name, d, xt, mean_row=nv / n)
        rows.append(time_case(
            "csr_spmm bf16" if state_bf16 else "csr_spmm",
            "forward A_w x over an edge shard", name,
            f"N={n} E={nv} D={d}{' bf16' if state_bf16 else ''}",
            lambda: csr_spmm(sg.rowptr, sg.row, sg.col, w, xt, n_edges=nv),
            lambda: csr_spmm_plain(sg.rowptr, sg.row, sg.col, w, xt),
            (4 * (n + 1 + 2 * nv + n * d) + xt.element_size() * n * d,
             2 * nv * d),
            lambda: csr @ x, timed=timed,
            reference=plain64(csr_spmm_plain, sg.rowptr, sg.row, sg.col, w,
                              xt)))
        if column_sum:
            rows += check_column_sum(name, sg, d, seed + world + r, dev=dev)
        if att is not None:
            rows += check_aggregate_kernels(
                name, sg, d, att, h, "scaled_dot", seed + 2 * world + r,
                timed=timed, dev=dev,
                payload=torch.bfloat16 if state_bf16 else None,
                row_bf16=state_bf16)
    return rows


SMEM_ROWS = 2_640 * 1_024       # probe 13's rows: 2,640 chunks x 1,024


def check_smem_gather(seed, d=128, m=SMEM_ROWS, dev="cuda"):
    """K21 ``smem_gather`` over probe 13's ``m`` random indices from tables
    [T, D] staged in shared memory: float32 at T = 8, 64 and 448 (the
    largest that fits in a block's 227 KB), bfloat16 at T = 512; each bit
    for bit against its plain version (``index_select``, which is also the
    yardstick) and relaunched bit-identical. A float32 table of 512 rows
    (256 KB) must be refused."""
    import torch
    from graph_neural_pde_tpu_torch.kernels import (smem_gather,
                                                    smem_gather_plain)
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for t, dtype in ((8, torch.float32), (64, torch.float32),
                     (448, torch.float32), (512, torch.bfloat16)):
        tab = torch.randn((t, d), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, t, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        es = tab.element_size()
        name = str(dtype).split(".")[1]
        rows.append(time_case(
            "smem_gather", f"table [{t}, {d}] {name}", "probe13",
            f"M={m} T={t} D={d}", lambda: smem_gather(idx, tab),
            lambda: smem_gather_plain(idx, tab),
            # reads the indices and the table once, writes [M, D]
            (4 * m + es * t * d + es * m * d, 0),
            lambda: torch.index_select(tab, 0, idx)))
        first = smem_gather(idx, tab)
        if not (torch.equal(first, smem_gather_plain(idx, tab))
                and torch.equal(first, smem_gather(idx, tab))):
            raise AssertionError(f"smem_gather T={t} {name}: not bit for bit")
    big = torch.randn((512, d), generator=gen, device=dev)
    try:
        smem_gather(idx[:16] % 512, big)
    except ValueError as err:
        print(f"[kernels] smem_gather refuses a float32 table [512, {d}] as "
              f"it should: {err}", flush=True)
    else:
        raise AssertionError("smem_gather took a 256 KB table")
    print("[kernels] smem_gather: bit for bit against index_select, two "
          "launches bit-identical", flush=True)
    return rows


def sharded_block_run(cfg, g, x, probe, spmm_fn, dev):
    """The block of ``cfg`` (weights from seed 0, on ``dev``) solved over
    ``g`` with ``spmm_fn`` (None: the default engine): (z, the gradients of
    sum(z * probe) in x and every block parameter, NFE), on the host."""
    import torch
    from graph_neural_pde_tpu_torch.models.blocks import (ODEBlock,
                                                          block_forward)
    block = ODEBlock(cfg, x.shape[1],
                     generator=torch.Generator().manual_seed(0)).to(dev)
    x = x.detach().to(dev).requires_grad_()
    z, stats = block_forward(block, cfg, g.to(dev), x, True, spmm_fn=spmm_fn)
    leaves = [x] + list(block.parameters())
    grads = torch.autograd.grad((z * probe.to(dev)).sum(), leaves,
                                allow_unused=True)
    return (z.detach().cpu(),
            [torch.zeros(t.shape) if g_ is None else g_.cpu()
             for t, g_ in zip(leaves, grads)], int(stats["nfe"]))


def same_block(label, got, want):
    """Two ``sharded_block_run`` results agree: NFE, z (rtol 1e-4) and every
    gradient (rtol 1e-3, with 1e-5 of the largest gradient allowed
    everywhere: a parameter whose true gradient is 0 holds rounding
    noise)."""
    import torch
    (z, gs, nfe), (z0, gs0, nfe0) = got, want
    if nfe != nfe0:
        raise AssertionError(f"{label}: NFE {nfe} vs {nfe0}")
    scale = float(z0.abs().max())
    if not torch.allclose(z, z0, rtol=1e-4, atol=1e-5 * scale):
        raise AssertionError(f"{label}: z differs by "
                             f"{float((z - z0).abs().max()):.3e} (scale "
                             f"{scale:.3e})")
    top = max(float(g_.abs().max()) for g_ in gs0)
    for i, (g_, g0) in enumerate(zip(gs, gs0)):
        if not torch.allclose(g_, g0, rtol=1e-3, atol=1e-5 * top):
            raise AssertionError(f"{label}: gradient {i} differs by "
                                 f"{float((g_ - g0).abs().max()):.3e} "
                                 f"(largest gradient {top:.3e})")
    return float((z - z0).abs().max()) / scale


def check_small_sharded_block(devices=("cpu", "cuda")):
    """The tuned Cora row's attention block at reduced width on the
    300-node SBM, solved with the stripe spmm (the P6 pair per rank) and
    the all-reduce spmm over an in-process 4-way split: card against CPU,
    and the card's against its unsharded block."""
    import torch
    from graph_neural_pde_tpu_torch.config import best_params
    from graph_neural_pde_tpu_torch.data.synthetic import make_sbm_dataset
    from graph_neural_pde_tpu_torch.models.blocks import prepare_graph
    from graph_neural_pde_tpu_torch.ops.graph import pad_capacity
    from graph_neural_pde_tpu_torch.parallel import split_mesh
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        make_sharded_spmm, make_sharded_stripe_spmm)
    cfg = best_params["Cora"].replace(hidden_dim=16, attention_dim=16,
                                      heads=4, input_dropout=0.0,
                                      dropout=0.0)
    d = make_sbm_dataset(num_nodes=300, num_classes=4, num_features=24,
                         seed=3, num_val=60)
    g = pad_capacity(prepare_graph(cfg, d.graph), 4).sort_by_row()
    gen = torch.Generator().manual_seed(5)
    x, probe = torch.randn(300, 16, generator=gen), torch.randn(
        300, 16, generator=gen)
    runs = {}
    for dev in devices:
        gd = g.to(dev)
        for engine, make in (("stripe", make_sharded_stripe_spmm),
                             ("allreduce", make_sharded_spmm),
                             ("default", None)):
            fn = None if make is None else make(split_mesh(4, dev), gd)
            runs[dev, engine] = sharded_block_run(cfg, gd, x, probe, fn, dev)
    cpu, card = devices
    for engine in ("stripe", "allreduce"):
        rel = same_block(f"sharded block ({engine}) {card} vs {cpu}",
                         runs[card, engine], runs[cpu, engine])
        rel0 = same_block(f"sharded block ({engine}) vs unsharded on {card}",
                          runs[card, engine], runs[card, "default"])
        print(f"[small] tuned Cora attention block, 4-way split, {engine}: "
              f"{card} vs {cpu} {rel:.2e}, vs the unsharded block "
              f"{rel0:.2e} of scale; NFE {runs[card, engine][2]}",
              flush=True)


def nccl_refuses_two_ranks_on_one_card(timeout=60):
    """Start a world of two NCCL ranks on card 0 in a process of its own:
    NCCL must refuse two ranks on one GPU ("Duplicate GPU detected"), which
    is why the card check runs one NCCL rank and the in-process split. Any
    other end (the world forms, another fault, no end within ``timeout``
    seconds) fails the run. The process and its children are stopped in
    every case."""
    import signal
    code = (
        "import os, sys, torch, torch.distributed as dist, "
        "torch.multiprocessing as mp\n"
        "def rank(r, port):\n"
        "    torch.cuda.set_device(0)\n"
        "    dist.init_process_group('nccl', init_method="
        "f'tcp://localhost:{port}', rank=r, world_size=2)\n"
        "    t = torch.ones(1, device='cuda')\n"
        "    dist.all_reduce(t)\n"
        "    torch.cuda.synchronize()\n"
        "    print('all_reduce', float(t), flush=True)\n"
        "if __name__ == '__main__':\n"
        "    mp.spawn(rank, args=(int(sys.argv[1]),), nprocs=2)\n")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "two_ranks.py")
        with open(script, "w") as f:
            f.write(code)
        proc = subprocess.Popen([sys.executable, script, str(free_port())],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            out = None
        finally:
            try:                        # the ranks, if any outlived it
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if out is None:
            proc.communicate()
            raise AssertionError(f"two NCCL ranks on one card: no end within "
                                 f"{timeout} s (stopped); expected NCCL's "
                                 f"refusal")
    lines = [ln for ln in out.splitlines() if "Duplicate GPU" in ln]
    if proc.returncode == 0 or not lines:
        raise AssertionError(f"two NCCL ranks on one card: exit code "
                             f"{proc.returncode} without NCCL's refusal: "
                             f"{out.strip()[-600:]}")
    print(f"[sharded] two NCCL ranks on one card refused in "
          f"{time.perf_counter() - t0:.1f} s (exit code {proc.returncode}): "
          f"{lines[0].strip()}", flush=True)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def drive_sharded_cora(data_dir: str, seed: int, dev: str = "cuda"):
    """(u), over a world of one NCCL rank: the tuned Cora row's attention
    block at full width (hidden 80, squareplus over columns, dopri5) over
    its stand-in, solved with ``spmm_fn`` from ``make_sharded_stripe_spmm``
    and from ``make_sharded_spmm_for`` in both modes, each held against the
    same block on the default engine, forward and backward; then GRAND-nl's
    attention RHS at the Cora GRAND-nl widths (D=80, ATT=128, H=8) through
    ``make_sharded_fused_rhs_for`` in both modes, forward against K6 and
    the two schedules' gradients against each other; then both dispatchers
    in both modes under the bf16 ODE state (x bfloat16; K1, K18 and K8's
    per-head mode read it and its payload in bfloat16), against the
    unsharded port at the same precision (``make_spmm`` on the bf16 x, K6
    on x widened, which is what JAX's type promotion computes)."""
    import torch
    from graph_neural_pde_tpu_torch.probes.gather import agree
    import torch.distributed as dist
    from graph_neural_pde_tpu_torch.config import Config, best_params
    from graph_neural_pde_tpu_torch.kernels import fused_rhs_fwd
    from graph_neural_pde_tpu_torch.parallel import make_mesh
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        MODES, make_sharded_fused_rhs_for, make_sharded_spmm_for,
        make_sharded_stripe_spmm)
    cfg = best_params["Cora"]
    dev = torch.device(dev)
    g = prepared_graph("Cora", data_dir).to(dev)
    mesh = make_mesh(1, dev, init_method=f"tcp://localhost:{free_port()}",
                     rank=0, world_size=1)
    try:
        n, d = g.num_nodes, cfg.hidden_dim
        gen = torch.Generator().manual_seed(seed)
        x, probe = (torch.randn(n, d, generator=gen),
                    torch.randn(n, d, generator=gen))
        want = sharded_block_run(cfg, g, x, probe, None, dev)
        for label, fn in (
                ("make_sharded_stripe_spmm", make_sharded_stripe_spmm(mesh, g)),
                *((f"make_sharded_spmm_for {m}", make_sharded_spmm_for(
                    cfg.replace(shard_spmm_mode=m), mesh, g)) for m in MODES)):
            rel = same_block(f"(u) {label}", sharded_block_run(
                cfg, g, x, probe, fn, dev), want)
            print(f"[sharded] tuned Cora attention block over one NCCL rank, "
                  f"{label}: NFE {want[2]}, z within {rel:.2e} of scale of "
                  f"the default engine's, gradients agree", flush=True)
        drive_sharded_stripe_bf16(mesh, g, cfg, x, probe, dev)
        nl = grand_nl_cora()
        h, att = nl.heads, nl.attention_dim
        gen = torch.Generator(device=dev).manual_seed(seed + 1)

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        ops = [randn(d, att, scale=d ** -0.5), randn(att, scale=0.1),
               randn(d, att, scale=d ** -0.5), randn(att, scale=0.1),
               randn(n, d)]
        ct = randn(n, d)
        ax6 = fused_rhs_fwd(g.rowptr, g.row, g.col, ops[4], *ops[:4],
                            torch.zeros(1, device=dev), heads=h,
                            score="scaled_dot", pieces=g.row_pieces)[0]
        grads = {}
        for mode in MODES:
            leaves = [t.clone().requires_grad_() for t in ops]
            out = make_sharded_fused_rhs_for(Config(shard_spmm_mode=mode),
                                             mesh, g, heads=h)(*leaves)
            _, rel = agree(f"(u) make_sharded_fused_rhs_for {mode} vs K6",
                             out.detach(), ax6)
            grads[mode] = torch.autograd.grad((out * ct).sum(), leaves)
            print(f"[sharded] fused RHS {mode} over one NCCL rank (N={n} "
                  f"D={d} ATT={att} H={h}): within {rel:.2e} of scale of K6",
                  flush=True)
        top = max(float(t.abs().max()) for t in grads["allreduce"])
        err = max(float((a - b).abs().max()) for a, b in
                  zip(grads["stream"], grads["allreduce"]))
        if not err <= REL_BOUND * top:
            raise AssertionError(f"(u) fused RHS gradients: stream vs "
                                 f"allreduce {err:.3e} > {REL_BOUND} x "
                                 f"{top:.3e}")
        print(f"[sharded] fused RHS gradients (qw, qb, kw, kb, x): stream vs "
              f"allreduce within {err / top:.2e} of the largest", flush=True)
        drive_sharded_bf16_state(mesh, g, ops, ct, h, seed + 2)
    finally:
        dist.destroy_process_group()


# the stripe spmm's bf16 payload rounds each product x_b[col] * w_b to
# bfloat16, make_spmm's payload (K1 reading the bf16 x beside float32
# weights) does not: their blocks' z may lie this far apart, of its scale
STRIPE_PRODUCT_GAP = 1e-2


def stripe_casts_spmm(g):
    """``spmm_fn(x, w)`` with the stripe spmm's bfloat16-payload semantics
    in plain torch ops over the whole graph: x and w rounded to bfloat16
    (the identity in the gradient), their product rounded again, its
    cotangent rounded to bfloat16 (what K20 writes), every sum float32."""
    import torch
    bf = torch.bfloat16
    r, c = g.row.long(), g.col.long()

    def rounded(t):
        t = t.float()
        return t + (t.to(bf).float() - t).detach()

    def spmm_fn(x, w):
        vals = (rounded(x)[c] * rounded(w)[:, None]).to(bf).float()
        vals = vals * g.mask[:, None]
        return torch.zeros((g.num_nodes, x.shape[1]), device=x.device,
                           dtype=torch.float32).index_add(0, r, vals)

    return spmm_fn


def drive_sharded_stripe_bf16(mesh, g, cfg, x, probe, dev):
    """(C), (u)'s stripe spmm under the bfloat16 payload over ``mesh``:
    ``cfg``'s block with the payload on a fixed grid (rk4, so that rounding
    noise moves no step) solved with ``make_sharded_stripe_spmm(...,
    payload_dtype=bf16)`` (K1 in table mode on the bf16 products, K20
    writing their bf16 gradient) against the same block on
    :func:`stripe_casts_spmm` (``same_block``), and its z's gap to the
    block on the default engine, ``make_spmm`` with the payload, printed
    (within ``STRIPE_PRODUCT_GAP``)."""
    import torch
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import \
        make_sharded_stripe_spmm
    cfg_b = cfg.replace(method="rk4", step_size=1.0,
                        rhs_payload_dtype="bfloat16")
    got = sharded_block_run(cfg_b, g, x, probe, make_sharded_stripe_spmm(
        mesh, g, payload_dtype=torch.bfloat16), dev)
    rel = same_block("(u) make_sharded_stripe_spmm bf16 payload", got,
                     sharded_block_run(cfg_b, g, x, probe,
                                       stripe_casts_spmm(g), dev))
    z_k1 = sharded_block_run(cfg_b, g, x, probe, None, dev)[0]
    gap = float((got[0] - z_k1).abs().max()) / float(z_k1.abs().max())
    if not gap <= STRIPE_PRODUCT_GAP:
        raise AssertionError(f"(u) stripe spmm bf16 payload: z {gap:.3e} of "
                             f"scale from make_spmm's payload")
    print(f"[sharded] tuned Cora attention block over one NCCL rank, "
          f"make_sharded_stripe_spmm with the bf16 payload (rk4, NFE "
          f"{got[2]}): z within {rel:.2e} of scale of the block on its "
          f"semantics in torch ops, gradients agree; {gap:.3e} of scale "
          f"from make_spmm's payload (products unrounded)", flush=True)


# x's bfloat16 gradient under the bf16 state: both schedules sum it partly
# in bfloat16 (autograd of the bf16 gather, as the JAX package's autodiff;
# ROADMAP R10), in other orders: four bf16 steps of its scale
BF16_SUM = 2.0 ** -6


def drive_sharded_bf16_state(mesh, g, ops, ct, h, seed):
    """(u)'s dispatchers under the bf16 ODE state over ``mesh``: x (the
    last of ``ops``) rounded to bfloat16, the config's payload and state
    bfloat16. ``make_sharded_spmm_for`` in both modes against ``make_spmm``
    on the same bf16 x (K1 on the bf16 table), forward and dx (bfloat16,
    its dtype checked); ``make_sharded_fused_rhs_for`` in both modes (K18
    and K8's per-head mode on the bf16 x and payload, all-reduce) against
    K6 on x widened to float32 (JAX's promotion), its gradients stream
    against all-reduce (x's within BF16_SUM)."""
    import torch
    from graph_neural_pde_tpu_torch.config import Config
    from graph_neural_pde_tpu_torch.kernels import fused_rhs_fwd
    from graph_neural_pde_tpu_torch.ops.spmm import make_spmm
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        MODES, make_sharded_fused_rhs_for, make_sharded_spmm_for)
    from graph_neural_pde_tpu_torch.probes.gather import agree
    dev = ops[4].device
    state = dict(dtype="bfloat16", rhs_payload_dtype="bfloat16")
    xb = ops[4].to(torch.bfloat16)
    n, d = xb.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((g.capacity,), generator=gen, device=dev) * g.mask

    def spmm_run(fn):
        x = xb.clone().requires_grad_()
        out = fn(x, w)
        dx, = torch.autograd.grad((out * ct).sum(), [x])
        if dx.dtype != torch.bfloat16 or out.dtype != torch.float32:
            raise AssertionError(f"(u) bf16 state: out {out.dtype}, dx "
                                 f"{dx.dtype}")
        return out.detach(), dx

    want, want_dx = spmm_run(make_spmm(g))
    for mode in MODES:
        out, dx = spmm_run(make_sharded_spmm_for(
            Config(shard_spmm_mode=mode, **state), mesh, g))
        _, rel = agree(f"(u) make_sharded_spmm_for {mode} bf16 state vs K1",
                       out, want)
        err = float((dx.float() - want_dx.float()).abs().max())
        top = float(want_dx.float().abs().max())
        if not err <= BF16_SUM * top:
            raise AssertionError(f"(u) spmm {mode} bf16 state dx: {err:.3e} "
                                 f"> {BF16_SUM} x {top:.3e}")
        print(f"[sharded] spmm {mode} under the bf16 state (N={n} D={d}): "
              f"within {rel:.2e} of scale of K1 on the bf16 table, dx "
              f"(bfloat16) within {err / top:.2e}", flush=True)
    ax6 = fused_rhs_fwd(g.rowptr, g.row, g.col, xb.float(), *ops[:4],
                        torch.zeros(1, device=dev), heads=h,
                        score="scaled_dot", pieces=g.row_pieces)[0]
    grads = {}
    for mode in MODES:
        leaves = [t.clone().requires_grad_() for t in ops[:4]] + [
            xb.clone().requires_grad_()]
        out = make_sharded_fused_rhs_for(Config(shard_spmm_mode=mode, **state),
                                         mesh, g, heads=h)(*leaves)
        _, rel = agree(f"(u) make_sharded_fused_rhs_for {mode} bf16 state "
                       f"vs K6", out.detach(), ax6)
        grads[mode] = torch.autograd.grad((out * ct).sum(), leaves)
        if grads[mode][4].dtype != torch.bfloat16:
            raise AssertionError(f"(u) fused {mode} bf16 state: dx "
                                 f"{grads[mode][4].dtype}")
        print(f"[sharded] fused RHS {mode} under the bf16 state: within "
              f"{rel:.2e} of scale of K6 on the widened state", flush=True)
    top = max(float(t.abs().max()) for t in grads["allreduce"][:4])
    err = max(float((a - b).abs().max()) for a, b in
              zip(grads["stream"][:4], grads["allreduce"][:4]))
    a, b = (grads[m][4].float() for m in ("stream", "allreduce"))
    err_x, top_x = float((a - b).abs().max()), float(b.abs().max())
    if not (err <= REL_BOUND * top and err_x <= BF16_SUM * top_x):
        raise AssertionError(f"(u) fused RHS bf16 state gradients: stream vs "
                             f"allreduce {err:.3e} of {top:.3e}, x "
                             f"{err_x:.3e} of {top_x:.3e}")
    print(f"[sharded] fused RHS gradients under the bf16 state: stream vs "
          f"allreduce within {err / top:.2e} of the largest (qw, qb, kw, "
          f"kb), x (bfloat16) within {err_x / top_x:.2e}", flush=True)


def drive_split_arxiv(big, seed: int, dev: str = "cuda"):
    """(u), the in-process 4-way split at arxiv scale: every rank's body in
    turn, the partials summed in rank order. The stripe spmm (K1 in table
    mode and its K20 backward per rank) and the all-reduce spmm (K1 per
    rank) at D=128 against K1 unsharded (dx against K1 over the reverse
    edges), and the all-reduce attention RHS at (a)'s widths (D=128,
    ATT=32, H=2; K18 per rank) against K6, in float32 and under the bf16
    ODE state (K18 on the bf16 x and payload; K6 on x widened)."""
    import torch
    from graph_neural_pde_tpu_torch.probes.gather import agree
    from graph_neural_pde_tpu_torch.config import GRAND_NL_BENCH
    from graph_neural_pde_tpu_torch.kernels import csr_spmm, fused_rhs_fwd
    from graph_neural_pde_tpu_torch.ops.graph import pad_capacity
    from graph_neural_pde_tpu_torch.ops.spmm import transpose_matvec
    from graph_neural_pde_tpu_torch.parallel import split_mesh
    from graph_neural_pde_tpu_torch.parallel.shard_spmm import (
        make_sharded_fused_rhs, make_sharded_spmm, make_sharded_stripe_spmm)
    dev = torch.device(dev)
    mesh = split_mesh(4, dev)
    g = big.to(dev)
    padded = pad_capacity(big, 4).sort_by_row().to(dev)
    n, d = g.num_nodes, GRAND_NL_BENCH.hidden_dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev)
    ct = torch.randn((n, d), generator=gen, device=dev)
    w = torch.rand((g.capacity,), generator=gen, device=dev) * g.mask
    want = csr_spmm(g.rowptr, g.row, g.col, w, x)
    xg = x.clone().requires_grad_()
    got = make_sharded_stripe_spmm(mesh, g)(xg, w)
    _, rel = agree("(u) stripe spmm, 4-way split, vs K1", got.detach(),
                     want)
    dx, = torch.autograd.grad((got * ct).sum(), [xg])
    _, rel_dx = agree("(u) stripe spmm dx, 4-way split, vs K1",
                        dx, transpose_matvec(g, w, ct))
    # (C) under the bf16 payload: each rank's bf16 products x_b[col] * w_b
    # (K1 in table mode, K20 writing the bf16 cotangent rows) against K1
    # unsharded in table mode over the same products, and dx against K1
    # over the reverse edges on the cotangent rounded to bfloat16 with the
    # rounded weights
    bf = torch.bfloat16
    nv = g.num_valid
    xg = x.clone().requires_grad_()
    got_b = make_sharded_stripe_spmm(mesh, g, payload_dtype=bf)(xg, w)
    prods = (x.to(bf).float()[g.col[:nv].long()]
             * w[:nv].to(bf).float()[:, None]).to(bf)
    want_b = csr_spmm(g.rowptr, g.row[:nv],
                      torch.arange(nv, dtype=torch.int32, device=dev),
                      torch.ones(nv, device=dev), prods, table=True)
    _, rel_b = agree("(u) stripe spmm bf16 payload, 4-way split, vs K1",
                     got_b.detach(), want_b)
    dx_b, = torch.autograd.grad((got_b * ct).sum(), [xg])
    _, rel_dx_b = agree("(u) stripe spmm bf16 payload dx, 4-way split, vs K1",
                        dx_b, transpose_matvec(g, w.to(bf).float(),
                                               ct.to(bf)))
    print(f"[sharded] 4-way split at arxiv scale, stripe spmm under the bf16 "
          f"payload: {rel_b:.2e} of scale of K1 in table mode over the same "
          f"bf16 products, dx {rel_dx_b:.2e} of K1 on the rounded cotangent",
          flush=True)
    w_pad = torch.cat([w, torch.zeros(padded.capacity - g.capacity,
                                      device=dev)])
    _, rel_ar = agree("(u) all-reduce spmm, 4-way split, vs K1",
                        make_sharded_spmm(mesh, padded)(x, w_pad), want)
    h, att = GRAND_NL_BENCH.heads, GRAND_NL_BENCH.attention_dim
    ops = [torch.randn((d, att), generator=gen, device=dev) * d ** -0.5,
           torch.randn((att,), generator=gen, device=dev) * 0.1,
           torch.randn((d, att), generator=gen, device=dev) * d ** -0.5,
           torch.randn((att,), generator=gen, device=dev) * 0.1]
    ax6 = fused_rhs_fwd(g.rowptr, g.row, g.col, x, *ops,
                        torch.zeros(1, device=dev), heads=h,
                        score="scaled_dot", pieces=g.row_pieces)[0]
    _, rel_f = agree("(u) fused RHS, 4-way split, vs K6",
                       make_sharded_fused_rhs(mesh, padded, heads=h)(*ops, x),
                       ax6)
    # the bf16 ODE state: every rank's K18 on the bf16 x and payload,
    # against K6 on x widened (JAX's promotion)
    xb = x.to(torch.bfloat16)
    ax6_b = fused_rhs_fwd(g.rowptr, g.row, g.col, xb.float(), *ops,
                          torch.zeros(1, device=dev), heads=h,
                          score="scaled_dot", pieces=g.row_pieces)[0]
    _, rel_b = agree("(u) fused RHS, 4-way split, bf16 state, vs K6",
                     make_sharded_fused_rhs(mesh, padded, heads=h)(*ops, xb),
                     ax6_b)
    print(f"[sharded] 4-way split at arxiv scale (N={n} E={g.num_valid}), "
          f"partials summed in rank order: stripe spmm {rel:.2e} and its dx "
          f"{rel_dx:.2e}, all-reduce spmm {rel_ar:.2e} of scale of K1; "
          f"fused RHS (D={d} ATT={att} H={h}) {rel_f:.2e} of K6, under the "
          f"bf16 state {rel_b:.2e}", flush=True)


GRAND_L_KERNELS = ("csr_spmm", "edge_dot", "segment_norm",
                   "segment_norm_bwd")
BLOCKED_KERNELS = ("blocked_spmm", "blocked_sddmm")
NORM1_KERNELS = ("norm1_den", "norm1_fwd", "norm1_bwd")
# K8 without dxg (csrc/fused_bwd_rows.cu, the column plan's row side):
# its launches counted apart from K8's with dxg, and those on the bf16
# column table apart again
ROWS = "fused_rhs_bwd without dxg"
ROWS_BF16 = f"{ROWS} bf16"
COLPLAN_KERNELS = ("fused_rhs_fwd", ROWS, "fused_rhs_bwd_col")
AGGREGATE_KERNELS = ("fused_aggregate", "fused_score_max",
                     "fused_rhs_bwd_heads")
# the node projections and the dKw reduction every fused kernel runs
# (csrc/dense.cuh)
DENSE = ("node_project", "outer_reduce")
ALL_KERNELS = GRAND_L_KERNELS + ("fused_rhs_fwd", "fused_rowmax",
                                 "fused_rhs_bwd", ROWS, "fused_rhs_bwd_sym",
                                 "dual_scatter", "dual_gather") \
    + NORM1_KERNELS + BLOCKED_KERNELS + ("fused_rhs_bwd_col",) \
    + AGGREGATE_KERNELS + ("row_gather", "smem_gather") + DENSE


# K1's launches in table mode (P6's scatter), counted apart among its own,
# and those of them on a bfloat16 table (the stripe spmm's bf16 payload)
TABLE_MODE = "csr_spmm table mode"
TABLE_BF16 = "csr_spmm table mode bf16"
# the launches on bfloat16 tables (the bf16 payload), counted apart among
# each kernel's own: "<kernel> bf16", and K6's with the exact mode's shifts
# apart again
SHIFTED_BF16 = "fused_rhs_fwd bf16 shifted"
BF16_NAMES = tuple(f"{k} bf16" for k in (
    "csr_spmm", "edge_dot", "fused_rhs_fwd", "fused_rowmax", "fused_rhs_bwd",
    "fused_rhs_bwd_sym", "fused_rhs_bwd_col", "norm1_den", "norm1_fwd",
    "norm1_bwd") + AGGREGATE_KERNELS + ("dual_scatter", "dual_gather",
                                        "row_gather")) + (SHIFTED_BF16,
                                                          TABLE_BF16,
                                                          ROWS_BF16)
# those the bench entry (t) launches: the primary op, the column-plan
# oracles, the softmax over columns (its oracles and keys) and the
# aggregate oracles over the bf16 payload
BENCH_BF16 = tuple(f"{k} bf16" for k in ("csr_spmm", "edge_dot",
                                         "fused_rhs_fwd", ROWS,
                                         "fused_rhs_bwd_sym",
                                         "fused_rhs_bwd_col", "norm1_den",
                                         "norm1_fwd", "norm1_bwd")
                   + AGGREGATE_KERNELS)


def counted(label: str, expected, fn):
    """Run ``fn`` with every kernel launch counter set to 0 just before and
    read just after; each kernel in ``expected`` must have been launched,
    and no walk over row pieces may have built its pieces on the fly.
    Returns (fn's result, launch counts, seconds)."""
    import torch
    from graph_neural_pde_tpu_torch import kernels
    for k in kernels.KERNELS + kernels.DENSE_KERNELS:
        k.launches = 0
    for k in kernels.BF16_KERNELS:
        k.bf16_launches = 0
    for k in kernels.ROW_WALKS:
        k.piece_builds = 0
    kernels.fused_rhs_fwd.bf16_shifted_launches = 0
    kernels.fused_rhs_bwd.rows_launches = 0
    kernels.fused_rhs_bwd.bf16_rows_launches = 0
    kernels.csr_spmm.table_launches = 0
    kernels.csr_spmm.table_bf16_launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    built = {k.__name__: k.piece_builds for k in kernels.ROW_WALKS
             if k.piece_builds}
    if built:
        raise AssertionError(f"{label}: row pieces built on the fly instead "
                             f"of the graph's own: {built}")
    launches = {k.__name__: k.launches
                for k in kernels.KERNELS + kernels.DENSE_KERNELS}
    launches[TABLE_MODE] = kernels.csr_spmm.table_launches
    launches[ROWS] = kernels.fused_rhs_bwd.rows_launches
    launches[ROWS_BF16] = kernels.fused_rhs_bwd.bf16_rows_launches
    for k in kernels.BF16_KERNELS:
        launches[f"{k.__name__} bf16"] = k.bf16_launches
    launches[SHIFTED_BF16] = kernels.fused_rhs_fwd.bf16_shifted_launches
    launches[TABLE_BF16] = kernels.csr_spmm.table_bf16_launches
    for name in expected:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on {label}")
    return res, launches, secs


def drive_poisoned_path(cfg, data_dir: str, seed: int):
    """The forced poison: ``cfg``'s model with Q and K redrawn so large
    that the unshifted softmax overflows at every evaluation. Each solve
    (train, eval and, where the model has one, early-stop eval,
    ``cfg.epoch - 1`` epochs) must detect the poison, re-solve with the
    exact softmax (over rows: K7's row maxima, K6 with shifts, K8 in the
    backward, on the bfloat16 column table under the bf16 payload or
    state; over columns: the composed attention on K3/K4 and K1/K2; the
    exp_kernel family, bounded by output_var^2, composes over rows too: K3
    and K10/K11) and come back finite. An exp_kernel model keeps its Q and
    K and takes output_var 20 and lengthscale 100 instead: every score
    near 400, far past exp's range."""
    import torch
    from graph_neural_pde_tpu_torch import run
    s = run.setup(cfg, data_dir, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    att = attention_layer(s.model)
    with torch.no_grad():
        if cfg.attention_type == "exp_kernel":
            att.output_var.fill_(20.0)
            att.lengthscale.fill_(100.0)
        else:
            for lin in (att.Q, att.K):
                lin.w.copy_(10.0 * torch.randn(lin.w.shape, generator=gen))
    losses = []
    for _ in range(1, cfg.epoch):
        loss, stats = s.trainer.train_step(s.x, s.y, s.masks[0])
        accs, logits, _ = s.trainer.eval_step(s.x, s.y, s.masks)
        zT = (s.model.apply_early(s.x, s.y, s.masks)[0]
              if hasattr(s.model, "apply_early") else logits)
        if not (math.isfinite(loss) and bool(torch.isfinite(logits).all())
                and bool(torch.isfinite(zT).all()) and stats["nfe"] > 0):
            raise AssertionError(f"poisoned path did not recover: loss "
                                 f"{loss}, stats {stats}")
        losses.append(loss)
    grads = [p.grad for p in s.model.parameters() if p.grad is not None]
    if not all(bool(torch.isfinite(g_).all()) for g_ in grads):
        raise AssertionError("poisoned path: non-finite gradient")
    return losses


def drive_bench_precision(seed: int, steps: int = 3, label: str = "(v)",
                          modes=("remat", "adjoint"), forward=True, **over):
    """(v) ``config.GRAND_NL_BENCH`` at bench.py's precision (the bfloat16
    payload and rk4 state) at full width over ogbn-arxiv-synthetic, its
    model and graph as the bench entry builds them: the folded eval
    forward, its logits against the float32 model's from the same weights
    (a difference of scale, printed; above 0.1 of the largest logit it
    fails), then ``steps`` training steps under remat and ``steps`` under
    the rk4 adjoint, each step's ms printed. ``over`` changes the model's
    config (``sym_backward=False``: path (w), the column-plan backward, its
    ``modes`` remat alone and no ``forward`` check). Returns each mode's
    step times (ms)."""
    import numpy as np
    import torch
    from graph_neural_pde_tpu_torch import bench as bench_entry
    from graph_neural_pde_tpu_torch.models.gnn import GNNModel
    from graph_neural_pde_tpu_torch.training.train import Trainer
    model, x, g_raw, nf, nc = bench_entry.build_benchmark(seed=seed,
                                                          device="cuda")
    cfg = model.cfg.replace(**over)
    if not cfg.rhs_payload_dtype == cfg.dtype == "bfloat16":
        raise AssertionError(f"{label} runs {cfg.rhs_payload_dtype} / "
                             f"{cfg.dtype}, not bench.py's bfloat16")
    state = model.state_dict()
    if forward:
        bench_forward(model, x, cfg, state, g_raw, nf, nc)
    del model
    rng = np.random.default_rng(seed + 1)
    n = x.shape[0]
    y = torch.as_tensor(rng.integers(0, nc, size=n), device="cuda")
    mask = torch.as_tensor(rng.random(n) < 0.5, device="cuda")
    modes_over = {"remat": dict(remat=True),
                  "adjoint": dict(adjoint=True, adjoint_method="rk4",
                                  adjoint_step_size=1.0)}
    step_ms = {}
    for mode in modes:
        m = GNNModel(cfg.replace(**modes_over[mode]), nf, nc, g_raw,
                     device="cuda")
        m.load_state_dict(state)
        trainer, ms, losses = Trainer(m), [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss, st = trainer.train_step(x, y, mask)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(loss):
                raise AssertionError(f"{label} {mode}: loss {loss}")
            losses.append(loss)
        print(f"[main] {label} {steps} {mode} steps at bench precision: ms "
              f"{[round(t, 2) for t in ms]}, losses {losses}, forward nfe "
              f"{st['nfe']}, backward nfe {st['bwd_nfe']}", flush=True)
        step_ms[mode] = ms
        del m, trainer
    return step_ms


def bench_forward(model, x, cfg, state, g_raw, nf, nc):
    """(v)'s folded eval forward at bench precision, its logits against
    those of the float32 model from the same weights."""
    import torch
    from graph_neural_pde_tpu_torch.config import FLOAT32
    from graph_neural_pde_tpu_torch.models.gnn import GNNModel
    m32 = GNNModel(cfg.replace(**FLOAT32), nf, nc, g_raw, device="cuda")
    m32.load_state_dict(state)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, stats = model(x, training=False)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        logits32, stats32 = m32(x, training=False)
    del m32
    if logits.shape != (x.shape[0], nc) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"(v) logits {tuple(logits.shape)}, finite: "
                             f"{bool(torch.isfinite(logits).all())}")
    scale = float(logits32.abs().max())
    diff = float((logits - logits32).abs().max())
    print(f"[main] (v) folded forward at bench precision: {fwd_ms:.1f} ms "
          f"(nfe {stats['nfe']}); logits against the float32 model's from "
          f"the same weights: max difference {diff:.4e} of the largest "
          f"{scale:.4e} ({diff / scale:.4e} of scale; nfe {stats32['nfe']})",
          flush=True)
    if diff > 0.1 * scale:
        raise AssertionError("(v) bf16 logits far from the float32 ones")


def drive_main_path(label: str, cfg, data_dir: str, expected):
    """``run.main`` on one config on the card, with every kernel launch
    counter set to 0 just before and read just after. Checks the epoch logs
    and that each kernel in ``expected`` was launched. Returns (result,
    launch counts)."""
    import torch
    from graph_neural_pde_tpu_torch import run
    torch.cuda.reset_peak_memory_stats()
    res, launches, secs = counted(
        label, expected,
        lambda: run.main(cfg, data_dir=data_dir, device="cuda"))
    epochs = cfg.epoch - 1
    print(f"[main] {epochs} epochs of {label} in {secs:.2f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"kernel launches {launches}", flush=True)
    if len(res.logs) != epochs:
        raise AssertionError(f"expected {epochs} epochs, got "
                             f"{len(res.logs)}")
    for log in res.logs:
        if not (math.isfinite(log.loss) and log.fwd_nfe > 0
                and log.bwd_nfe > 0):
            raise AssertionError(f"bad epoch log {log}")
    if not 0.0 < res.best["val_acc"] <= 1.0:
        raise AssertionError(f"bad best {res.best}")
    return res, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from graph_neural_pde_tpu_torch.config import (FLOAT32, GRAND_NL_BENCH,
                                                   best_params)
    from graph_neural_pde_tpu_torch.kernels import build
    from graph_neural_pde_tpu_torch.ops.graph import pad_capacity
    from graph_neural_pde_tpu_torch.probes.gather import (arxiv_scale_graph,
                                                          card)

    # 1. environment
    t_run = time.perf_counter()

    def phase_done(name):
        print(f"[phase] {name} done at {time.perf_counter() - t_run:.1f} s",
              flush=True)

    smi = card()
    kind = torch.cuda.get_device_name(0)
    print(f"[env] nvidia-smi: {smi}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    print(f"[build] {lib_path.name}: {time.perf_counter() - t0:.2f} s",
          flush=True)

    with tempfile.TemporaryDirectory() as data_dir:
        phase_done("2 (build)")
        # 3. kernels against their plain versions
        # the node projections and the dKw reduction of every fused kernel:
        # (a)'s widths (D=128, ATT=32) at arxiv scale first, then BLEND's
        # (ATT=2 x 32), the Cora GRAND-nl widths (D=80, ATT=128) and kNN
        # Cora BLEND's (D=64+32, ATT=2 x 128) at Cora's node count
        nl, bench = grand_nl_cora(), GRAND_NL_BENCH.replace(**FLOAT32)
        n_arxiv, n_cora = 169_343, 2_708
        rows = check_dense_kernels("arxiv-scale", n_arxiv, bench.hidden_dim,
                                   bench.attention_dim, args.seed + 240,
                                   reduce_bf16=True)
        rows += check_dense_kernels("arxiv-scale", n_arxiv, bench.hidden_dim,
                                    2 * bench.attention_dim, args.seed + 241,
                                    modes=(0, 2))
        rows += check_dense_kernels("cora-standin", n_cora, nl.hidden_dim,
                                    nl.attention_dim, args.seed + 242)
        rows += check_dense_kernels(
            "cora-knn", n_cora, nl.feat_hidden_dim + nl.pos_enc_hidden_dim,
            2 * nl.attention_dim, args.seed + 243, modes=(0, 1))
        # ... and K8's per-head form over the bench oracle's payload rows
        og = oracle_graph(0)
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 244)
        rows.append(check_outer_reduce(
            "bench-oracle", torch.randn((og.capacity, 128), generator=gen,
                                        device="cuda"), None,
            torch.randn((og.capacity, 64), generator=gen, device="cuda"),
            " per edge"))
        cora_g = prepared_graph("Cora", data_dir)
        rows += check_kernels("cora-standin", cora_g,
                              best_params["Cora"].hidden_dim, args.seed)
        # the Cora stand-in with a hub row of degree 360 ("cora-hub"): K9
        # and K14 cut it into row pieces and merge them, and so do K3 / K4
        cora_hub = hub_graph(cora_g, 360, args.seed + 230)
        # K3 / K4 at the main path's shape: the tuned Cora row normalises
        # its attention over columns (rev) at its H; and on cora-hub, whose
        # hub's segment takes several pieces
        rows += check_segment_kernels("cora-standin", cora_g,
                                      best_params["Cora"].heads,
                                      args.seed + 246)
        rows += check_segment_kernels("cora-hub", cora_hub,
                                      best_params["Cora"].heads,
                                      args.seed + 247)
        rows += check_segment_kernels(
            "computers-standin", prepared_graph("Computers", data_dir),
            best_params["Computers"].heads, args.seed + 2)
        # bench.py's GRAND-nl architecture in float32 (bench): the paths
        # and checks before the bfloat16 mode; (t) and (v) run its own
        # precision
        rows += check_fused_kernels("cora-standin", cora_g, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 20)
        # the same widths over cora-hub
        rows += check_fused_kernels("cora-hub", cora_hub, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 231, multi_rows=True)
        rows += check_norm1_kernels("cora-hub", cora_hub, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 232, multi_rows=True)
        # the exact mode's shifts: K7's maxima against K6's scores
        check_exact_shifts("cora-one-edge", cora_g.num_nodes, nl.hidden_dim,
                           nl.attention_dim, nl.heads, args.seed + 233)
        check_exact_shifts("arxiv-one-edge", 20_000, bench.hidden_dim,
                           bench.attention_dim, bench.heads, args.seed + 234)
        # the bfloat16 payload: K1 and K2 on bf16 tables at the tuned Cora
        # row's width, K6 and K9 on the bf16 column table at the Cora
        # GRAND-nl widths and, every family, small
        bf16 = torch.bfloat16
        rows += check_kernels("cora-standin", cora_g,
                              best_params["Cora"].hidden_dim, args.seed + 140,
                              table=bf16)
        rows += check_fused_kernels("cora-standin", cora_g, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 141, payload=bf16)
        for i, score in enumerate(SCORE_FAMILIES):
            rows += check_fused_kernels("cora-small", cora_g, 16, 16, 4,
                                        score, args.seed + 142 + i,
                                        timed=False, payload=bf16)
        for i, score in enumerate(SCORE_FAMILIES):
            rows += check_fused_kernels("cora-small", cora_g, 16, 16, 4,
                                        score, args.seed + 30 + i,
                                        timed=False)
        # K18, K19 and K8's per-head mode over a random per-edge payload:
        # every family small, scaled_dot at the bench oracle's shape
        for i, score in enumerate(SCORE_FAMILIES):
            rows += check_aggregate_kernels("cora-small", cora_g, 16, 16, 4,
                                            score, args.seed + 110 + i,
                                            timed=False)
        rows += check_aggregate_kernels("bench-oracle", oracle_graph(0), 128,
                                        64, 2, "scaled_dot", args.seed + 115)
        # ... at the Cora GRAND-nl widths over the hub row of degree 360,
        # which the scaled-dot walks cut into row pieces and merge, and
        # with squareplus in place of the exp (small, and over the hub)
        rows += check_aggregate_kernels("cora-hub", cora_hub, nl.hidden_dim,
                                        nl.attention_dim, nl.heads,
                                        "scaled_dot", args.seed + 118)
        for name, graph, d_sp, att_sp, h_sp in (
                ("cora-small", cora_g, 16, 16, 4),
                ("cora-hub", cora_hub, nl.hidden_dim, nl.attention_dim,
                 nl.heads)):
            rows += check_aggregate_kernels(name, graph, d_sp, att_sp, h_sp,
                                            "scaled_dot", args.seed + 119,
                                            timed=False, square_plus=True)
        # ... and over a bfloat16 payload (the JAX bench's oracle feeds P8,
        # P9 and P11 one) beside a float32 and a bfloat16 row side: every
        # family small, the oracle's shape timed
        for i, score in enumerate(SCORE_FAMILIES):
            for row_b16 in (False, True):
                rows += check_aggregate_kernels(
                    "cora-small", cora_g, 16, 16, 4, score,
                    args.seed + 200 + 2 * i + row_b16, timed=False,
                    payload=bf16, row_bf16=row_b16)
        for row_b16 in (False, True):
            rows += check_aggregate_kernels(
                "bench-oracle", oracle_graph(0), 128, 64, 2, "scaled_dot",
                args.seed + 210 + row_b16, payload=bf16, row_bf16=row_b16)
        # ... and at the Cora GRAND-nl widths, on the stand-in and over the
        # hub row, timed with their bounds
        for name, graph in (("cora-standin", cora_g), ("cora-hub", cora_hub)):
            for row_b16 in (False, True):
                rows += check_aggregate_kernels(
                    name, graph, nl.hidden_dim, nl.attention_dim, nl.heads,
                    "scaled_dot", args.seed + 212 + row_b16, payload=bf16,
                    row_bf16=row_b16)
        # ... K18 of the four families that need each edge's key (the
        # tensor-core key tile over windows of row pieces), timed at the
        # Cora GRAND-nl widths over the hub row (BLEND's score packing its
        # two halves into the same ATT), float32 and bf16 payloads (after
        # the main paths' shapes, which the closing line reports)
        for i, score in enumerate(SCORE_FAMILIES[1:]):
            for payload_k in (None, torch.bfloat16):
                rows += check_aggregate_kernels(
                    "cora-hub", cora_hub, nl.hidden_dim, nl.attention_dim,
                    nl.heads, score, args.seed + 240 + i,
                    payload=payload_k, kernels=("fused_aggregate",))
        rows += check_dual_kernels("cora-standin", cora_g, nl.hidden_dim,
                                   nl.heads, args.seed + 51)
        rows += check_dual_kernels("cora-small", cora_g, 16, 4,
                                   args.seed + 50)
        # ... over the hub row of degree 360, which the kernels cut into
        # row pieces and merge
        rows += check_dual_kernels("cora-hub", cora_hub, nl.hidden_dim,
                                   nl.heads, args.seed + 55)
        # K1 in table mode as K11's dx at the Cora GRAND-nl widths (H=8:
        # a table of width 10)
        rows += check_head_sum("cora-standin", cora_g, nl.hidden_dim,
                               nl.heads, args.seed + 53)
        # K10 and K11 on the bfloat16 column table: small (untimed), and
        # timed at the Cora GRAND-nl widths beside the float32 check above
        rows += check_dual_kernels("cora-small", cora_g, 16, 4,
                                   args.seed + 220, timed=False, table=bf16)
        rows += check_dual_kernels("cora-standin", cora_g, nl.hidden_dim,
                                   nl.heads, args.seed + 221, table=bf16)
        rows += check_norm1_kernels("cora-standin", cora_g, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 60)
        for i, score in enumerate(SCORE_FAMILIES):
            rows += check_norm1_kernels("cora-small", cora_g, 16, 16, 4,
                                        score, args.seed + 70 + i,
                                        timed=False)
        # K12-K14 on the bfloat16 column table at the Cora GRAND-nl widths,
        # with a float32 row side (timed) and a bfloat16 one, and every
        # family small
        rows += check_norm1_kernels("cora-standin", cora_g, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 180, payload=bf16)
        rows += check_norm1_kernels("cora-standin", cora_g, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 181, timed=False,
                                    payload=bf16, row_bf16=True)
        for i, score in enumerate(SCORE_FAMILIES):
            rows += check_norm1_kernels("cora-small", cora_g, 16, 16, 4,
                                        score, args.seed + 182 + i,
                                        timed=False, payload=bf16)
        # the blocked engine's shapes: reordered Cora and ogbn-arxiv
        # stand-ins at their rows' widths, the image CLI's batches (64
        # MNIST-shaped grids, D=1; 64 CIFAR-shaped grids with diagonals,
        # D=3) and an 8-neighbour grid at ogbn-arxiv's node count
        rows += check_blocked_kernels(
            "cora-rcm", prepared_graph("Cora", data_dir, node_reorder="rcm"),
            best_params["Cora"].hidden_dim, args.seed + 80)
        rows += check_blocked_kernels(
            "arxiv-standin-rcm",
            prepared_graph("ogbn-arxiv", data_dir, node_reorder="rcm"),
            best_params["ogbn-arxiv"].hidden_dim, args.seed + 81)
        rows += check_blocked_kernels("mnist-batch64", grid_graph(64, 28, 28,
                                                                  False),
                                      1, args.seed + 82)
        rows += check_blocked_kernels("cifar-batch64", grid_graph(64, 32, 32,
                                                                  True),
                                      3, args.seed + 83)
        rows += check_blocked_kernels("grid-412x411", grid_graph(1, 412, 411,
                                                                 True),
                                      128, args.seed + 84)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        big = arxiv_scale_graph(args.seed)
        print(f"[kernels] arxiv-scale graph built on the host in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rows += check_kernels("arxiv-scale", big, 128, args.seed + 1)
        # the bfloat16 payload at arxiv scale: K1 / K2 at D=128; K6 / K9 at
        # the bench's widths under its bf16 state (x itself bf16, timed), and
        # with a float32 row side
        rows += check_kernels("arxiv-scale", big, 128, args.seed + 150,
                              table=bf16)
        rows += check_fused_kernels("arxiv-scale", big, bench.hidden_dim,
                                    bench.attention_dim, bench.heads,
                                    "scaled_dot", args.seed + 151,
                                    payload=bf16, row_bf16=True)
        rows += check_fused_kernels("arxiv-scale", big, bench.hidden_dim,
                                    bench.attention_dim, bench.heads,
                                    "scaled_dot", args.seed + 152,
                                    timed=False, payload=bf16)
        for h in (1, 8):
            rows += check_segment_kernels("arxiv-scale", big, h,
                                          args.seed + 3 + h)
        rows += check_fused_kernels("arxiv-scale", big, bench.hidden_dim,
                                    bench.attention_dim, bench.heads,
                                    "scaled_dot", args.seed + 21)
        rows += check_dual_kernels("arxiv-scale", big, bench.hidden_dim,
                                   bench.heads, args.seed + 52)
        # ... and at (f)'s (H=2: width 64)
        rows += check_head_sum("arxiv-scale", big, bench.hidden_dim,
                               bench.heads, args.seed + 54)
        rows += check_dual_kernels("arxiv-scale", big, bench.hidden_dim,
                                   bench.heads, args.seed + 222, table=bf16)
        rows += check_norm1_kernels("arxiv-scale", big, bench.hidden_dim,
                                    bench.attention_dim, bench.heads,
                                    "scaled_dot", args.seed + 61)
        # BLEND's split-space score at the bench's BLEND widths: D=128,
        # packed q and k of 2 x 32 columns, 2 heads (paths (q) and (r))
        rows += check_fused_kernels("arxiv-scale", big, bench.hidden_dim,
                                    2 * bench.attention_dim, bench.heads,
                                    BELTRAMI, args.seed + 22)
        rows += check_norm1_kernels("arxiv-scale", big, bench.hidden_dim,
                                    2 * bench.attention_dim, bench.heads,
                                    BELTRAMI, args.seed + 62)
        # K12-K14 on the bfloat16 column table at (y)'s widths and at the
        # BLEND widths: under the bench's bf16 state (x itself bf16, timed)
        # and with a float32 row side (untimed)
        for att_w, score, sd in ((bench.attention_dim, "scaled_dot", 190),
                                 (2 * bench.attention_dim, BELTRAMI, 192)):
            for row_b16, timed in ((True, True), (False, False)):
                rows += check_norm1_kernels(
                    "arxiv-scale", big, bench.hidden_dim, att_w,
                    bench.heads, score, args.seed + sd + (not row_b16),
                    timed=timed, payload=bf16, row_bf16=row_b16)
        rows += check_aggregate_kernels("arxiv-scale", big, bench.hidden_dim,
                                        bench.attention_dim, bench.heads,
                                        "scaled_dot", args.seed + 116)
        rows += check_aggregate_kernels("arxiv-scale", big, bench.hidden_dim,
                                        2 * bench.attention_dim, bench.heads,
                                        BELTRAMI, args.seed + 117)
        # ... over the bfloat16 payload at (a)'s and the BLEND widths, with
        # the bench's bf16 row side and a float32 one
        for att_w, score, sd in ((bench.attention_dim, "scaled_dot", 212),
                                 (2 * bench.attention_dim, BELTRAMI, 214)):
            for row_b16 in (True, False):
                rows += check_aggregate_kernels(
                    "arxiv-scale", big, bench.hidden_dim, att_w, bench.heads,
                    score, args.seed + sd + row_b16, payload=bf16,
                    row_bf16=row_b16)
        # the P6 pair (K1 in table mode, K20) on every rank of a 4-way
        # split at arxiv scale (path (u)'s split), on ranks 0 and 3 of one
        # of the Cora stand-in, and on the one NCCL rank's whole shard of
        # it at D=80 (path (u)'s sharded block); K21 at probe 13's shapes
        d_cora = best_params["Cora"].hidden_dim
        rows += check_shard_kernels("arxiv-scale", big, bench.hidden_dim,
                                    args.seed + 120, ranks=(0, 1, 2, 3))
        rows += check_shard_kernels("cora-standin", cora_g, d_cora,
                                    args.seed + 122)
        rows += check_shard_kernels("cora-standin", cora_g, d_cora,
                                    args.seed + 123, ranks=(0,), world=1)
        # ... under the stripe spmm's bfloat16 payload: K1 in table mode on
        # a bf16 payload, K20 writing bf16 rows
        rows += check_shard_kernels("arxiv-scale", big, bench.hidden_dim,
                                    args.seed + 223, ranks=(0, 3), bf16=True)
        rows += check_shard_kernels("cora-standin", cora_g, d_cora,
                                    args.seed + 224, ranks=(0,), world=1,
                                    bf16=True)
        rows += check_smem_gather(args.seed + 124)
        # the all-reduce schedules' edge shards at path (u)'s widths: the
        # one NCCL rank's Cora shard (K1 and its dx over the CSC view at
        # D=80 in the block; K18 and K8's per-head mode at the Cora
        # GRAND-nl widths in the attention RHS), and the 4-way split's
        # shards at arxiv scale (K1 at D=128, K18 at (a)'s widths). The
        # arxiv-scale graph stays for path (u)
        rows += check_edge_shard_kernels(
            "cora-standin", cora_g, 1, d_cora, args.seed + 125,
            att=nl.attention_dim, h=nl.heads, column_sum=True)
        rows += check_edge_shard_kernels(
            "arxiv-scale", pad_capacity(big, 4).sort_by_row(), 4,
            bench.hidden_dim, args.seed + 126, att=bench.attention_dim,
            h=bench.heads)
        # ... and under the bf16 ODE state (K1, K18, K19 and K8's per-head
        # mode on the bf16 x and payload), as (u) runs the dispatchers
        rows += check_edge_shard_kernels(
            "cora-standin", cora_g, 1, d_cora, args.seed + 216,
            att=nl.attention_dim, h=nl.heads, state_bf16=True)
        rows += check_edge_shard_kernels(
            "arxiv-scale", pad_capacity(big, 4).sort_by_row(), 4,
            bench.hidden_dim, args.seed + 217, att=bench.attention_dim,
            h=bench.heads, state_bf16=True)
        torch.cuda.empty_cache()
        # directed graphs: K17 and K8 without dxg (four score families on a
        # small random graph; the GDC-rewired Cora stand-in at (n)'s widths;
        # arxiv scale at (o)'s), K1 as the column sum and K3/K4 over the CSC
        # view
        gdc_cora = best_params["Cora"].replace(rewiring="gdc")
        t0 = time.perf_counter()
        cora_gdc = gdc_graph(gdc_cora, data_dir)
        print(f"[kernels] Cora stand-in rewired by GDC on the card (ppr, "
              f"exact={gdc_cora.exact}, top {gdc_cora.gdc_k} per column) "
              f"in {time.perf_counter() - t0:.2f} s: {cora_gdc.num_valid} "
              f"edges with self loops, symmetric: {cora_gdc.rev is not None}",
              flush=True)
        if cora_gdc.rev is not None:
            raise AssertionError("the GDC-rewired Cora stand-in is symmetric")
        small_dir = directed_random_graph(2000, 16_000, args.seed + 90)
        for i, score in enumerate(SCORE_FAMILIES):
            rows += check_column_rhs_kernels("directed-small", small_dir, 16,
                                             16, 4, score, args.seed + 91 + i,
                                             timed=False, piece=4)
        rows += check_column_rhs_kernels("cora-gdc", cora_gdc, nl.hidden_dim,
                                         nl.attention_dim, nl.heads,
                                         "scaled_dot", args.seed + 95)
        # the column-plan backward and the exact re-solve on the bfloat16
        # column table: every family small (untimed), the GDC graph at
        # (n)'s widths with a float32 row side
        for i, score in enumerate(SCORE_FAMILIES):
            rows += check_column_rhs_kernels("directed-small", small_dir, 16,
                                             16, 4, score, args.seed + 160 + i,
                                             timed=False, payload=bf16,
                                             piece=4)
        rows += check_fused_kernels("cora-gdc", cora_gdc, nl.hidden_dim,
                                    nl.attention_dim, nl.heads, "scaled_dot",
                                    args.seed + 165, payload=bf16)
        rows += check_column_rhs_kernels("cora-gdc", cora_gdc, nl.hidden_dim,
                                         nl.attention_dim, nl.heads,
                                         "scaled_dot", args.seed + 166,
                                         payload=bf16)
        rows += check_column_sum("cora-gdc", cora_gdc,
                                 best_params["Cora"].hidden_dim,
                                 args.seed + 96)
        rows += check_segment_kernels("cora-gdc", cora_gdc,
                                      best_params["Cora"].heads,
                                      args.seed + 97)
        rows += check_dual_kernels("cora-gdc", cora_gdc, nl.hidden_dim,
                                   nl.heads, args.seed + 104)
        # (s)'s graph and widths: the Cora stand-in rewired by pos_enc_knn
        # (its DW64 encoding by DeepWalk on the card, cached in data_dir,
        # where (s) reads it again), whose hub columns reach in-degrees of
        # hundreds; BLEND at D = 64 + 32, packed ATT 2 x 128, H = 8: K6
        # and K8 at their widest node tables, K8 without dxg and K17
        t0 = time.perf_counter()
        knn_g = prepared_graph("Cora", data_dir, rewiring="pos_enc_knn",
                               pos_enc_type="DW64")
        print(f"[kernels] Cora stand-in rewired by pos_enc_knn over DW64 "
              f"on the card in {time.perf_counter() - t0:.2f} s: "
              f"{knn_g.num_valid} edges with self loops", flush=True)
        blend_d = nl.feat_hidden_dim + nl.pos_enc_hidden_dim
        rows += check_fused_kernels("cora-knn", knn_g, blend_d,
                                    2 * nl.attention_dim, nl.heads, BELTRAMI,
                                    args.seed + 107, feat=nl.feat_hidden_dim,
                                    multi_rows=True)
        rows += check_column_rhs_kernels("cora-knn", knn_g, blend_d,
                                         2 * nl.attention_dim, nl.heads,
                                         BELTRAMI, args.seed + 108,
                                         feat=nl.feat_hidden_dim,
                                         multi_rows=True)
        rows += check_column_rhs_kernels("cora-knn", knn_g, blend_d,
                                         2 * nl.attention_dim, nl.heads,
                                         BELTRAMI, args.seed + 167,
                                         feat=nl.feat_hidden_dim,
                                         payload=bf16)
        t0 = time.perf_counter()
        big_dir = directed_random_graph(169_343, 1_166_243, args.seed)
        print(f"[kernels] directed arxiv-scale graph built on the host in "
              f"{time.perf_counter() - t0:.1f} s: {big_dir.num_valid} edges",
              flush=True)
        rows += check_column_rhs_kernels("arxiv-directed", big_dir,
                                         bench.hidden_dim, bench.attention_dim,
                                         bench.heads, "scaled_dot",
                                         args.seed + 98)
        rows += check_column_rhs_kernels("arxiv-directed", big_dir,
                                         bench.hidden_dim,
                                         2 * bench.attention_dim,
                                         bench.heads, BELTRAMI,
                                         args.seed + 106)
        # at bench precision (the bf16 state: x itself bf16, timed) and
        # with a float32 row side (untimed): K6 (shifted too), K7, K8 and
        # K17 on the bfloat16 column table
        for row_b16, timed, sd in ((True, True, 168), (False, False, 170)):
            rows += check_fused_kernels("arxiv-directed", big_dir,
                                        bench.hidden_dim, bench.attention_dim,
                                        bench.heads, "scaled_dot",
                                        args.seed + sd, timed=timed,
                                        payload=bf16, row_bf16=row_b16)
            rows += check_column_rhs_kernels(
                "arxiv-directed", big_dir, bench.hidden_dim,
                bench.attention_dim, bench.heads, "scaled_dot",
                args.seed + sd + 1, timed=timed, payload=bf16,
                row_bf16=row_b16)
        rows += check_column_sum("arxiv-directed", big_dir, bench.hidden_dim,
                                 args.seed + 99)
        # the dKw reduction gathered through the column index over the
        # slots, K8 with dxg's form
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 245)
        slot_col = big_dir.col.to("cuda")
        rows.append(check_outer_reduce(
            "arxiv-directed", torch.randn((big_dir.num_nodes,
                                           bench.hidden_dim), generator=gen,
                                          device="cuda"), slot_col,
            torch.randn((slot_col.numel(), bench.attention_dim),
                        generator=gen, device="cuda"), " slots"))
        for h in (1, 8):
            rows += check_segment_kernels("arxiv-directed", big_dir, h,
                                          args.seed + 100 + h)
        rows += check_dual_kernels("arxiv-directed", big_dir,
                                   bench.hidden_dim, bench.heads,
                                   args.seed + 105)
        del big_dir
        torch.cuda.empty_cache()

        print_slower_than_library(rows)
        print_slower_than_plain(rows, names=("fused_rhs_bwd", "fused_rowmax",
                                             "fused_aggregate",
                                             "fused_score_max",
                                             "fused_rhs_bwd_heads"))
        phase_done("3 (kernels)")
        # 4. end to end on small inputs, card vs CPU
        check_small_end_to_end("Cora")
        # the bfloat16 payload (float32 state) on the fixed grid: K1/K2 on
        # bf16 tables in the tuned Cora row, K6/K9 on the bf16 column table
        # in Cora GRAND-nl (see check_small_end_to_end)
        bf16_rk4 = dict(rhs_payload_dtype="bfloat16", method="rk4",
                        step_size=1.0)
        check_small_end_to_end("Cora bf16 payload",
                               base=best_params["Cora"].replace(**bf16_rk4))
        check_small_end_to_end("Cora GRAND-nl bf16 payload",
                               base=grand_nl_cora().replace(**bf16_rk4))
        # the column-plan backward (K6, K8 and K17 on the bf16 column
        # table) with the payload, and at bench.py's precision (the bf16
        # rk4 state too)
        colplan = grand_nl_cora().replace(sym_backward=False, **bf16_rk4)
        check_small_end_to_end("Cora GRAND-nl colplan bf16 payload",
                               base=colplan)
        check_small_end_to_end("Cora GRAND-nl colplan bench precision",
                               base=colplan.replace(dtype="bfloat16"))
        # the softmax over columns (K12-K14 on the bf16 column table) with
        # the payload, and at bench.py's precision
        cols_bf16 = grand_nl_cora().replace(attention_norm_idx=1, **bf16_rk4)
        check_small_end_to_end("Cora GRAND-nl column softmax bf16 payload",
                               base=cols_bf16, grad_floor=BF16_COLUMN_FLOOR)
        check_small_end_to_end(
            "Cora GRAND-nl column softmax bench precision",
            base=cols_bf16.replace(dtype="bfloat16"),
            grad_floor=BF16_COLUMN_FLOOR)
        check_small_end_to_end("Computers")
        check_small_end_to_end("Cora GRAND-nl", base=nl)
        # the composed RHS differentiates through the global score max, and
        # K's gradient is a remainder of cancelling sums 300 times below
        # the largest gradient: 1e-5 of the largest is rounding noise there
        check_small_end_to_end("Cora GRAND-nl squareplus",
                               base=nl.replace(square_plus=True),
                               early_stop_counts=False, grad_floor=1e-5)
        check_small_end_to_end("Cora GAT", base=nl.replace(function="GAT"),
                               early_stop_counts=False, grad_floor=1e-5)
        # squareplus and GAT with the bf16 payload and at bench.py's
        # precision: k (GAT: s_dst) from the bf16 column table, K10/K11 on
        # it (tolerances as the bf16 checks above, grad_floor as the
        # float32 ones)
        for label, over in (("Cora GRAND-nl squareplus",
                             dict(square_plus=True)),
                            ("Cora GAT", dict(function="GAT"))):
            composed = nl.replace(**over, **bf16_rk4)
            check_small_end_to_end(f"{label} bf16 payload", base=composed,
                                   early_stop_counts=False, grad_floor=1e-5)
            check_small_end_to_end(f"{label} bench precision",
                                   base=composed.replace(dtype="bfloat16"),
                                   early_stop_counts=False, grad_floor=1e-5)
        # the row's own normalisation axis: the softmax over columns
        nl1 = nl.replace(attention_norm_idx=1)
        check_small_end_to_end("Cora GRAND-nl column softmax", base=nl1)
        # the blocked engine (K15/K16) over 128-node blocks
        check_small_end_to_end(
            "Cora blocked", base=best_params["Cora"].replace(
                spmm_impl="pallas_blocked", spmm_block_n=128,
                spmm_chunk=128))
        for engine in ("xla", "pallas_blocked"):
            check_small_image(engine)
        # a directed graph: the 300-node SBM rewired by GDC once, on the
        # card, at the CLI's defaults, and handed to both devices (the
        # dense diffusion may differ in its last bits between devices)
        small_gdc = small_gdc_graph()
        check_small_end_to_end("Cora over GDC", base=best_params["Cora"],
                               graph=small_gdc)
        check_small_end_to_end("Cora GRAND-nl over GDC", base=nl,
                               graph=small_gdc)
        # K10/K11 with dx by K1 over the CSC view (tolerances as above)
        check_small_end_to_end("Cora GRAND-nl squareplus over GDC",
                               base=nl.replace(square_plus=True),
                               graph=small_gdc, early_stop_counts=False,
                               grad_floor=1e-5)
        check_small_end_to_end("Cora GAT over GDC",
                               base=nl.replace(function="GAT"),
                               graph=small_gdc, early_stop_counts=False,
                               grad_floor=1e-5)
        # BLEND: the dual encoder and the split-space score, in the fused
        # engines over rows (K6, K9) and columns (K12-K14), in the frozen
        # attention of the tuned Cora row, over a pos_enc_knn graph (K6,
        # K8 without dxg, K17), and the tuned ogbn-arxiv row's dual encoder
        blend = dict(beltrami=True, attention_type="exp_kernel")
        check_small_end_to_end("BLEND GRAND-nl", base=nl.replace(**blend),
                               pos_dim=5)
        check_small_end_to_end("BLEND GRAND-nl column softmax",
                               base=nl1.replace(**blend), pos_dim=5)
        check_small_end_to_end("BLEND Cora attention block",
                               base=best_params["Cora"].replace(**blend),
                               pos_dim=5)
        check_small_end_to_end("tuned ogbn-arxiv with beltrami",
                               base=best_params["ogbn-arxiv"].replace(
                                   beltrami=True), pos_dim=8)
        # the sharded tuned Cora block over an in-process 4-way split
        check_small_sharded_block()
        small_knn = check_deepwalk_and_knn(data_dir)
        check_small_end_to_end("BLEND GRAND-nl over pos_enc_knn",
                               base=nl.replace(**blend), graph=small_knn,
                               pos_dim=16)

        phase_done("4 (end to end, card against CPU)")
        # 5. the main paths
        fused = ("fused_rhs_fwd", "fused_rhs_bwd_sym") + DENSE
        dual = ("dual_scatter", "dual_gather")
        # (q), (r): the BLEND architecture of bench.py (feature width 96,
        # positions 32) over its random graph, with its seeded N(0, 1)
        # encoding of width 32, read from the encodings' cache as a
        # computed one would be
        blend_bench = bench.replace(
            epoch=2, seed=args.seed, beltrami=True,
            attention_type="exp_kernel", feat_hidden_dim=96,
            pos_enc_hidden_dim=32, pos_enc_type="DW32")
        os.makedirs(os.path.join(data_dir, "pos_encodings"), exist_ok=True)
        np.savez(os.path.join(data_dir, "pos_encodings",
                              f"{bench.dataset}_DW32.npz"),
                 pe=np.random.default_rng(7).normal(
                     size=(169_343, 32)).astype(np.float32))
        paths = (
            ("tuned Cora", best_params["Cora"].replace(epoch=2),
             GRAND_L_KERNELS),
            ("tuned Cora again", best_params["Cora"].replace(epoch=2),
             GRAND_L_KERNELS),
            ("tuned Computers", best_params["Computers"].replace(epoch=2),
             ("csr_spmm", "edge_dot", "segment_norm")),
            ("tuned Pubmed", best_params["Pubmed"].replace(epoch=2),
             GRAND_L_KERNELS),
            ("GRAND-nl arxiv-scale (a)", bench.replace(epoch=2,
                                                       seed=args.seed), fused),
            ("GRAND-nl Cora (b)", nl.replace(epoch=2), fused),
            ("GRAND-nl Cora squareplus (d)",
             nl.replace(square_plus=True, epoch=2), dual),
            ("GAT Cora (e)", nl.replace(function="GAT", epoch=2), dual),
            ("GRAND-nl arxiv-scale squareplus (f)",
             bench.replace(square_plus=True, epoch=2, seed=args.seed), dual),
            ("GRAND-nl Cora column softmax (g)", nl1.replace(epoch=2),
             NORM1_KERNELS),
            ("GRAND-nl arxiv-scale column softmax (h)",
             bench.replace(attention_norm_idx=1, epoch=2, seed=args.seed),
             NORM1_KERNELS),
            ("tuned ogbn-arxiv over its stand-in (i)",
             best_params["ogbn-arxiv"].replace(epoch=2),
             ("csr_spmm", "edge_dot", "segment_norm")),
            ("tuned ogbn-arxiv with label diffusion (i)",
             best_params["ogbn-arxiv"].replace(epoch=2, use_labels=True),
             ("csr_spmm", "edge_dot", "segment_norm")),
            ("tuned Cora on the blocked engine after rcm (j)",
             best_params["Cora"].replace(epoch=2, spmm_impl="pallas_blocked",
                                         node_reorder="rcm"),
             BLOCKED_KERNELS),
            ("tuned Cora over GDC (m)", gdc_cora.replace(epoch=2),
             GRAND_L_KERNELS),
            ("GRAND-nl Cora over GDC (n)", nl.replace(epoch=2,
                                                      rewiring="gdc"),
             COLPLAN_KERNELS),
            ("GRAND-nl arxiv-scale sym_backward=False (o)",
             bench.replace(epoch=2, seed=args.seed, sym_backward=False),
             COLPLAN_KERNELS),
            ("tuned ogbn-arxiv with beltrami, DW64 on the card (p)",
             best_params["ogbn-arxiv"].replace(epoch=2, beltrami=True),
             ("csr_spmm", "edge_dot", "segment_norm")),
            ("BLEND GRAND-nl arxiv-scale (q)", blend_bench, fused),
            ("BLEND GRAND-nl arxiv-scale column softmax (r)",
             blend_bench.replace(attention_norm_idx=1),
             NORM1_KERNELS + DENSE),
            ("BLEND GRAND-nl Cora over pos_enc_knn (s)",
             nl.replace(epoch=2, rewiring="pos_enc_knn", pos_enc_type="DW64",
                        **blend), COLPLAN_KERNELS + DENSE),
            # (B) (e) at bench.py's precision: s_dst and K10/K11 on the
            # bfloat16 column table
            ("GAT Cora at bench precision (B)",
             nl.replace(function="GAT", epoch=2, dtype="bfloat16",
                        **bf16_rk4), ("dual_scatter bf16", "dual_gather bf16")),
        )
        results, per_path = {}, {}
        launches = dict.fromkeys(ALL_KERNELS + (TABLE_MODE,) + BF16_NAMES, 0)
        for label, cfg, expected in paths:
            res, counts = drive_main_path(label, cfg, data_dir, expected)
            results[label] = res
            per_path[label] = counts
        # (t) the bench entry at full width: its oracles (K1, K6, K8's
        # per-head mode, K9, K10, K12-K14, K17-K19) and its timings; it
        # prints its JSON line
        from graph_neural_pde_tpu_torch import bench as bench_entry
        label_t = "bench entry (t)"
        _, per_path[label_t], secs = counted(
            label_t, AGGREGATE_KERNELS + ("csr_spmm", "fused_rhs_fwd",
                                          "fused_rhs_bwd_sym", "dual_scatter",
                                          "fused_rhs_bwd_col", "norm1_bwd")
            + BENCH_BF16,
            lambda: bench_entry.main(device="cuda"))
        print(f"[main] {label_t} in {secs:.2f} s; kernel launches "
              f"{per_path[label_t]}", flush=True)
        # (v) bench.py's GRAND-nl at its precision: the bf16 column table
        # in K6 and K9, the bf16 rk4 state
        label_v = "GRAND-nl arxiv-scale at bench precision (v)"
        _, per_path[label_v], secs = counted(
            label_v,
            ("fused_rhs_fwd bf16", "fused_rhs_bwd_sym bf16") + DENSE,
            lambda: drive_bench_precision(args.seed))
        print(f"[main] {label_v} in {secs:.2f} s; kernel launches "
              f"{per_path[label_v]}", flush=True)
        # (w) (o) at bench.py's precision: the column-plan backward (K8
        # without dxg, K17) on the bf16 column table, never K9
        label_w = ("GRAND-nl arxiv-scale sym_backward=False at bench "
                   "precision (w)")
        _, per_path[label_w], secs = counted(
            label_w, ("fused_rhs_fwd bf16", ROWS_BF16,
                      "fused_rhs_bwd_col bf16"),
            lambda: drive_bench_precision(args.seed, label="(w)",
                                          modes=("remat",), forward=False,
                                          sym_backward=False))
        if per_path[label_w]["fused_rhs_bwd_sym"]:
            raise AssertionError(f"{label_w} launched K9: "
                                 f"{per_path[label_w]}")
        print(f"[main] {label_w} in {secs:.2f} s; kernel launches "
              f"{per_path[label_w]}", flush=True)
        # (y) (h) at bench.py's precision: the softmax over columns, K12-K14
        # on the bf16 column table
        label_y = ("GRAND-nl arxiv-scale column softmax at bench precision "
                   "(y)")
        _, per_path[label_y], secs = counted(
            label_y, tuple(f"{k} bf16" for k in NORM1_KERNELS),
            lambda: drive_bench_precision(args.seed, label="(y)",
                                          modes=("remat",), forward=False,
                                          attention_norm_idx=1))
        print(f"[main] {label_y} in {secs:.2f} s; kernel launches "
              f"{per_path[label_y]}", flush=True)
        # (A) (f) at bench.py's precision: squareplus, k from the bf16
        # column table, K10/K11 on it
        label_a = ("GRAND-nl arxiv-scale squareplus at bench precision (A)")
        step_ms, per_path[label_a], secs = counted(
            label_a, ("dual_scatter bf16", "dual_gather bf16"),
            lambda: drive_bench_precision(args.seed, label="(A)",
                                          modes=("remat",), forward=False,
                                          square_plus=True))
        epoch_f = results["GRAND-nl arxiv-scale squareplus (f)"].logs[0]
        print(f"[main] {label_a} in {secs:.2f} s: remat steps "
              f"{[round(t, 2) for t in step_ms['remat']]} ms beside (f)'s "
              f"float32 epoch {epoch_f.runtime * 1e3:.2f} ms; kernel "
              f"launches {per_path[label_a]}", flush=True)
        # (u) the multi-device layer: NCCL refuses two ranks on one card,
        # so a world of one NCCL rank drives every sharded function and the
        # sharded tuned Cora block, and the 4-way split's per-rank bodies
        # run rank by rank in this process; then the gather probes
        from graph_neural_pde_tpu_torch.probes import gather as probes
        nccl_refuses_two_ranks_on_one_card()
        for label, expected, fn in (
                ("sharded Cora over one NCCL rank (u)",
                 ("csr_spmm", TABLE_MODE, "edge_dot", "segment_norm",
                  "row_gather", "fused_aggregate", "fused_rhs_bwd_heads",
                  "csr_spmm bf16", "fused_aggregate bf16",
                  "fused_rhs_bwd_heads bf16", TABLE_BF16, "row_gather bf16"),
                 lambda: drive_sharded_cora(data_dir, args.seed + 130)),
                ("4-way split at arxiv scale (u)",
                 ("csr_spmm", TABLE_MODE, "row_gather", "fused_aggregate",
                  "fused_aggregate bf16", TABLE_BF16, "row_gather bf16"),
                 lambda: drive_split_arxiv(big, args.seed + 131)),
                ("gather probes (u)",
                 ("csr_spmm", TABLE_MODE, "row_gather", "smem_gather",
                  "fused_rhs_fwd",
                  "fused_rhs_bwd_sym", "norm1_fwd", "norm1_bwd"),
                 lambda: probes.main([], graph=big))):
            _, per_path[label], secs = counted(label, expected, fn)
            print(f"[main] {label} in {secs:.2f} s; kernel launches "
                  f"{per_path[label]}", flush=True)
        del big
        torch.cuda.empty_cache()
        label = "tuned Cora on the blocked engine after rcm (j)"
        if per_path[label]["csr_spmm"] or per_path[label]["edge_dot"]:
            raise AssertionError(f"{label} launched K1/K2: "
                                 f"{per_path[label]}")
        # (m) ran over the directed graph built above from the same config
        # (no rev: every column-side pass walked the CSC view); (n), (o)
        # and (s) took the column-plan backward, never K9
        label_m = "tuned Cora over GDC (m)"
        label_o = "GRAND-nl arxiv-scale sym_backward=False (o)"
        for label in ("GRAND-nl Cora over GDC (n)", label_o,
                      "BLEND GRAND-nl Cora over pos_enc_knn (s)"):
            if per_path[label]["fused_rhs_bwd_sym"]:
                raise AssertionError(f"{label} launched K9: "
                                     f"{per_path[label]}")
        print(f"[main] (m) trained over the GDC-rewired Cora stand-in: "
              f"{cora_gdc.num_valid} edges with self loops, no reverse-edge "
              f"map; K3 {per_path[label_m]['segment_norm']} and K4 "
              f"{per_path[label_m]['segment_norm_bwd']} launches over "
              f"its CSC view", flush=True)
        # (s)'s graph, built above: each node's k nearest by DeepWalk
        # distance, whose columns (in-degrees, K17's walks) are as uneven
        # as the encodings' hubs make them
        in_deg = (knn_g.colptr[1:] - knn_g.colptr[:-1]).float()
        print(f"[main] (s) trained over the Cora stand-in rewired by "
              f"pos_enc_knn: {knn_g.num_valid} edges with self loops, "
              f"symmetric: {knn_g.rev is not None}; in-degree mean "
              f"{float(in_deg.mean()):.1f}, median "
              f"{float(in_deg.median()):.0f}, max {int(in_deg.max())}",
              flush=True)
        epoch_a = results["GRAND-nl arxiv-scale (a)"].logs[0].runtime
        epoch_o = results[label_o].logs[0].runtime
        print(f"[main] GRAND-nl arxiv-scale epoch: (a) K9 backward "
              f"{epoch_a:.4f} s, (o) K8 + K17 column-plan backward "
              f"{epoch_o:.4f} s ({epoch_o / epoch_a:.3f}x)", flush=True)
        # (k) the image CLI on the blocked engine, without and with remat;
        # (l) on the default engine (K1)
        images = {}
        for label, cfg, expected in (
                ("image CLI on the blocked engine (k)",
                 image_config(spmm_impl="pallas_blocked"), ("blocked_spmm",)),
                ("image CLI on the blocked engine with remat (k)",
                 image_config(spmm_impl="pallas_blocked", remat=True),
                 ("blocked_spmm",)),
                ("image CLI on the default engine (l)", image_config(),
                 ("csr_spmm",))):
            hist, counts, peak = drive_image_path(label, cfg, data_dir,
                                                  expected)
            images[label] = (hist, peak)
            per_path[label] = counts
        (h_k, peak_k), (h_kr, peak_kr), (h_l, _) = images.values()
        if h_k != h_kr:
            raise AssertionError(f"remat changed the image losses: {h_k} vs "
                                 f"{h_kr}")
        if not math.isclose(h_k[0][0], h_l[0][0], rel_tol=1e-4):
            raise AssertionError(f"image losses differ between the engines: "
                                 f"{h_k} vs {h_l}")
        print(f"[main] image CLI peak device memory without remat "
              f"{peak_k:.4f} GiB, with remat {peak_kr:.4f} GiB; losses "
              f"identical with and without remat, blocked vs default "
              f"{h_k[0][0]:.6f} vs {h_l[0][0]:.6f}", flush=True)
        poisoned = (
            ("GRAND-nl Cora forced poison (c)", nl,
             ("fused_rhs_fwd", "fused_rowmax", "fused_rhs_bwd")),
            # the fast solve poisons in K12/K13; the re-solve composes the
            # exact column softmax. Attention normalised over columns is
            # not row-stochastic, and as sharp as these scores make it its
            # row sums reach the node degrees: the exact state grows like
            # exp(alpha (row sum - 1) t) and leaves float32 before the row's
            # 3T = 55, so this solve is cut to T = 2
            ("GRAND-nl Cora column softmax forced poison (g)",
             nl1.replace(time=2.0),
             ("norm1_den", "norm1_fwd", "segment_norm", "segment_norm_bwd",
              "csr_spmm", "edge_dot")),
            # (x) the forced poison at bench.py's precision (the bf16
            # payload and rk4 state): the exact re-solve on the bfloat16
            # column table, K7, K6 shifted and K8 with dxg
            ("GRAND-nl Cora forced poison at bench precision (x)",
             nl.replace(rhs_payload_dtype="bfloat16", dtype="bfloat16",
                        method="rk4", step_size=1.0),
             ("fused_rowmax bf16", SHIFTED_BF16, "fused_rhs_bwd bf16")),
            ("GRAND-nl arxiv-scale forced poison at bench precision (x)",
             GRAND_NL_BENCH.replace(seed=args.seed),
             ("fused_rowmax bf16", SHIFTED_BF16, "fused_rhs_bwd bf16")),
            # (z) (g) at bench.py's precision: the fast solve poisons in K12
            # and K13 on the bfloat16 column table, the re-solve composes
            # the exact column softmax over the bf16 state (K3/K4, K1/K2 on
            # the bf16 table); T = 2 as in (g)
            # (B) the exp_kernel family's forced poison at bench.py's
            # precision at T = 2: the fast solve poisons in K6 on the bf16
            # column table, the exact re-solve composes (K3/K4, K10/K11 on
            # the bf16 table)
            ("GRAND-nl Cora exp_kernel forced poison at bench precision (B)",
             nl.replace(attention_type="exp_kernel", dtype="bfloat16",
                        time=2.0, **bf16_rk4),
             ("fused_rhs_fwd bf16", "segment_norm", "segment_norm_bwd",
              "dual_scatter bf16", "dual_gather bf16")),
            ("GRAND-nl Cora column softmax forced poison at bench precision "
             "(z)",
             nl1.replace(rhs_payload_dtype="bfloat16", dtype="bfloat16",
                         method="rk4", step_size=1.0, time=2.0),
             ("norm1_den bf16", "norm1_fwd bf16", "segment_norm",
              "segment_norm_bwd", "csr_spmm bf16", "edge_dot bf16")))
        for label, cfg, expected in poisoned:
            losses, counts, secs = counted(
                label, expected,
                lambda: drive_poisoned_path(cfg.replace(epoch=2), data_dir,
                                            args.seed + 40))
            per_path[label] = counts
            print(f"[main] 1 epoch of {label} in {secs:.2f} s, losses "
                  f"{losses}; kernel launches {counts}", flush=True)
        for counts in per_path.values():
            for k, v in counts.items():
                launches[k] += v
    cora_losses = [[log.loss for log in results[k].logs]
                   for k in ("tuned Cora", "tuned Cora again")]
    print(f"[main] two runs of tuned Cora agree bit for bit: "
          f"{cora_losses[0] == cora_losses[1]} (losses {cora_losses[0]} and "
          f"{cora_losses[1]})", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main paths")

    pallas = "graph_neural_pde_tpu/ops/pallas/"
    sources = {"csr_spmm": ("csr_spmm.cu", "stripe.py:513"),
               "edge_dot": ("edge_dot.cu", "stripe.py:363"),
               "segment_norm": ("segment_norm.cu", "stripe.py:412"),
               "segment_norm_bwd": ("segment_norm.cu", "stripe.py:412"),
               "fused_rhs_fwd": ("fused_fwd.cu", "fused_rhs.py:280"),
               "fused_rowmax": ("fused_fwd.cu", "fused_rhs.py:654"),
               "fused_rhs_bwd": ("fused_bwd_edges.cu", "fused_rhs.py:742"),
               ROWS: ("fused_bwd_rows.cu", "fused_rhs.py:742"),
               "fused_rhs_bwd_sym": ("fused_rhs.cu", "fused_rhs.py:1341"),
               "dual_scatter": ("dual_scatter.cu", "stripe.py:599"),
               "dual_gather": ("dual_gather.cu", "stripe.py:655"),
               "norm1_den": ("norm1_den.cu", "fused_rhs.py:2070"),
               "norm1_fwd": ("norm1.cu", "fused_rhs.py:2189"),
               "norm1_bwd": ("norm1.cu", "fused_rhs.py:2297"),
               "blocked_spmm": ("blocked.cu", "spmm_blocked.py:76"),
               "blocked_sddmm": ("blocked.cu", "spmm_blocked.py:135"),
               "fused_rhs_bwd_col": ("fused_rhs.cu", "fused_rhs.py:1047"),
               "fused_aggregate": ("payload_fwd.cu", "fused_rhs.py:208"),
               "fused_score_max": ("payload_fwd.cu", "fused_rhs.py:569"),
               "fused_rhs_bwd_heads": ("payload_bwd.cu", "fused_rhs.py:742"),
               "row_gather": ("row_gather.cu", "stripe.py:767"),
               "smem_gather": ("smem_gather.cu",
                               "examples/perf_probe13_vmem_gather.py:85"),
               # inside the fused kernels: q_blk / k_e of P7, P13, P15, and
               # P11's, P13's, P16's dkw_ref products
               "node_project": ("dense.cuh", "fused_rhs.py:235"),
               "outer_reduce": ("dense.cuh", "fused_rhs.py:872"),
               # the bfloat16-table modes (the bf16 payload)
               "csr_spmm bf16": ("csr_spmm.cu", "stripe.py:513"),
               "edge_dot bf16": ("edge_dot.cu", "stripe.py:363"),
               "fused_rhs_fwd bf16": ("fused_fwd.cu", "fused_rhs.py:280"),
               "fused_rhs_bwd_sym bf16": ("fused_rhs.cu",
                                          "fused_rhs.py:1341"),
               SHIFTED_BF16: ("fused_fwd.cu", "fused_rhs.py:280"),
               "fused_rowmax bf16": ("fused_fwd.cu", "fused_rhs.py:654"),
               "fused_rhs_bwd bf16": ("fused_bwd_edges.cu",
                                      "fused_rhs.py:742"),
               ROWS_BF16: ("fused_bwd_rows.cu", "fused_rhs.py:742"),
               "fused_rhs_bwd_col bf16": ("fused_rhs.cu",
                                          "fused_rhs.py:1047"),
               "norm1_den bf16": ("norm1_den.cu", "fused_rhs.py:2070"),
               "norm1_fwd bf16": ("norm1.cu", "fused_rhs.py:2189"),
               "norm1_bwd bf16": ("norm1.cu", "fused_rhs.py:2297"),
               "fused_aggregate bf16": ("payload_fwd.cu",
                                        "fused_rhs.py:208"),
               "fused_score_max bf16": ("payload_fwd.cu",
                                        "fused_rhs.py:569"),
               "fused_rhs_bwd_heads bf16": ("payload_bwd.cu",
                                            "fused_rhs.py:742"),
               "dual_scatter bf16": ("dual_scatter.cu", "stripe.py:599"),
               "dual_gather bf16": ("dual_gather.cu", "stripe.py:655"),
               TABLE_BF16: ("csr_spmm.cu", "stripe.py:746"),
               "row_gather bf16": ("row_gather.cu", "stripe.py:767")}
    summary = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "ms" in r]
        main_shape = timed[0]         # the first check at a main path's shape
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        summary.append({
            "name": name, "route": "cuda",
            "source": f"graph_neural_pde_tpu_torch/csrc/{src}",
            "replaces": (replaces if replaces.startswith("examples/")
                         else pallas + replaces),
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # the bound is on this one: error over the largest reference entry
            "max_rel_err": max(r["max_rel_err"] for r in mine),
            **{k: main_shape[k] for k in keys},
            "shape": f"{main_shape['shape']} {main_shape['dims']}",
            "launches_by_path": {p: c[name] for p, c in per_path.items()},
            **({"table_mode_launches": launches[TABLE_MODE],
                "table_mode_launches_by_path": {
                    p: c[TABLE_MODE] for p, c in per_path.items()}}
               if name == "csr_spmm" else {}),
            "other_checks": [
                {k: r[k] for k in ("check", "shape", "dims") + keys}
                for r in timed[1:]]})
    phase_done("5 (main paths)")
    print(card(), flush=True)     # the card's name and power limit
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
