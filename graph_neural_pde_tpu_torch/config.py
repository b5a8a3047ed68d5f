"""Immutable experiment configuration (PyTorch port).

A field-for-field copy of ``graph_neural_pde_tpu.config``: the same frozen
``Config`` dataclass, the same defaults and the same tuned ``best_params``
rows. The port keeps its own copy because importing the JAX package pulls
in jax, which the GPU machine does not have. Fields that only steer the TPU
engines (stripe tiling, Pallas switches, mesh layout) are kept so that a
config round-trips between the two packages; the port ignores them.

``best_params`` reproduces the tuned configs of the reference's
src/best_params.py:1-8.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # ---- data ----------------------------------------------------------
    dataset: str = "Cora"
    data_norm: str = "rw"              # 'rw' | 'gcn'
    self_loop_weight: float = 1.0
    use_labels: bool = False
    label_rate: float = 0.5
    planetoid_split: bool = False
    geom_gcn_splits: bool = False
    num_splits: int = 1
    # Passed through as use_lcc verbatim (reference run_GNN.py:223 ->
    # data.py:34): True => extract the largest connected component (the ref
    # default, despite the name); ogbn-arxiv sets False (best_params.py:7).
    not_lcc: bool = True

    # ---- GNN -----------------------------------------------------------
    hidden_dim: int = 16
    fc_out: bool = False
    input_dropout: float = 0.5
    dropout: float = 0.0
    batch_norm: bool = False
    optimizer: str = "adam"            # sgd rmsprop adagrad adam adamax
    lr: float = 0.01
    decay: float = 5e-4                # weight decay
    epoch: int = 100
    alpha: float = 1.0
    alpha_dim: str = "sc"
    no_alpha_sigmoid: bool = False
    beta_dim: str = "sc"
    block: str = "constant"            # constant mixed attention hard_attention rewire_attention
    function: str = "laplacian"        # laplacian transformer GAT
    use_mlp: bool = False
    add_source: bool = False

    # ---- ODE -----------------------------------------------------------
    time: float = 1.0
    augment: bool = False
    method: str = "dopri5"             # dopri5 euler rk4 midpoint adaptive_heun
    step_size: float = 1.0
    max_iters: int = 100
    # rematerialise fixed-grid solver steps in backprop: O(steps) activation
    # memory becomes O(1) steps' worth at the cost of one extra forward —
    # the non-adjoint counterpart of the reference's odeint_adjoint memory
    # strategy. Required for full-batch arxiv-scale training without the
    # adjoint (stored fused-RHS residuals exceed HBM otherwise).
    remat: bool = False
    adjoint: bool = False
    adjoint_method: str = "adaptive_heun"
    adjoint_step_size: float = 1.0
    tol_scale: float = 1.0
    tol_scale_adjoint: float = 1.0
    ode_blocks: int = 1
    max_nfe: int = 1000
    no_early: bool = True              # early-stop test integrator off by default here
    earlystopxT: float = 3.0
    max_test_steps: int = 100

    # ---- attention -----------------------------------------------------
    leaky_relu_slope: float = 0.2
    attention_dropout: float = 0.0
    heads: int = 4
    attention_norm_idx: int = 0        # 0 = normalise over rows, 1 = over cols
    attention_dim: int = 64
    mix_features: bool = False
    reweight_attention: bool = False
    attention_type: str = "scaled_dot"  # scaled_dot cosine_sim pearson exp_kernel
    square_plus: bool = False

    # ---- regularisation -------------------------------------------------
    jacobian_norm2: Optional[float] = None
    total_deriv: Optional[float] = None
    kinetic_energy: Optional[float] = None
    directional_penalty: Optional[float] = None

    # ---- rewiring --------------------------------------------------------
    rewiring: Optional[str] = None     # two_hop | gdc
    gdc_method: str = "ppr"            # ppr heat coeff
    gdc_sparsification: str = "topk"   # threshold topk
    gdc_k: int = 64
    gdc_threshold: float = 0.0001
    gdc_avg_degree: int = 64
    ppr_alpha: float = 0.05
    heat_time: float = 3.0
    exact: bool = False
    att_samp_pct: float = 1.0
    use_flux: bool = False
    M_nodes: int = 64
    new_edges: str = "random"          # random random_walk k_hop
    sparsify: str = "S_hat"
    threshold_type: str = "topk_adj"
    rw_addD: float = 0.02
    rw_rmvR: float = 0.02
    rewire_KNN: bool = False
    rewire_KNN_T: str = "T0"
    rewire_KNN_epoch: int = 5
    rewire_KNN_k: int = 64
    rewire_KNN_sym: bool = False
    KNN_online: bool = False
    KNN_online_reps: int = 4
    KNN_space: str = "pos_distance"
    edge_sampling: bool = False
    edge_sampling_T: str = "T0"
    edge_sampling_epoch: int = 5
    edge_sampling_add: float = 0.64
    edge_sampling_add_type: str = "importance"
    edge_sampling_rmv: float = 0.32
    edge_sampling_sym: bool = False
    edge_sampling_online: bool = False
    edge_sampling_online_reps: int = 4
    edge_sampling_space: str = "attention"
    symmetric_attention: bool = False
    fa_layer: bool = False
    fa_layer_edge_sampling_rmv: float = 0.8
    pos_dist_quantile: float = 0.001

    # ---- beltrami / positional encodings --------------------------------
    beltrami: bool = False
    pos_enc_type: str = "DW64"         # GDC DW64 DW128 DW256 HYP...
    pos_enc_orientation: str = "row"
    feat_hidden_dim: int = 64
    pos_enc_hidden_dim: int = 32
    pos_enc_dim: int = 0               # set from the loaded encoding

    # ---- TPU / framework knobs (new; no reference analogue) -------------
    dtype: str = "float32"             # state dtype; attention matmuls may use bf16
    # fold the attention normalisation into the aggregation scatter when the
    # normalisation axis equals the aggregation axis (attention_norm_idx==0):
    # exact for square_plus (whose max is global by reference semantics,
    # utils.py:196); for softmax it substitutes the global max for per-node
    # maxes (identical result up to f32 underflow). Cuts the per-RHS indexed
    # ops from ~6 to ~3 — indexed gathers/scatters are the TPU bottleneck.
    fused_attention_agg: bool = True
    # terms for method='cheby' (exact Chebyshev expm solve of the linear
    # frozen-attention diffusion); 0 = auto from T
    cheby_terms: int = 0
    # sparse aggregation engine: 'xla' (gather+segment-sum; best for uniform
    # sparsity) or 'pallas_blocked' (one-hot MXU kernels over node blocks;
    # best for block-local graphs: pixel grids, clustered/reordered graphs)
    spmm_impl: str = "xla"
    # load-time node relabeling (ops/reorder.py): 'rcm' (reverse Cuthill-
    # McKee) or 'degree' lay community/hub structure into contiguous node
    # blocks so the pallas_blocked plan concentrates near the diagonal;
    # semantics-neutral (features/labels/masks ride the permutation)
    node_reorder: str = "none"
    # multi-chip aggregation collective schedule (parallel.shard_spmm):
    # 'allreduce' — per-shard [N, D] partials merged by one psum (default);
    # 'stream' — edge-streaming ring (make_sharded_spmm_stream and, for the
    # GRAND-nl attention RHS, make_sharded_fused_rhs_stream): rows block-
    # sharded, x blocks ride nd−1 collective-permutes of [N/nd, D] each —
    # half the AllReduce bytes for the matvec, ~2H× less for the attention
    # RHS (raw feature block vs [N,H·D]+[N,H] num/den psums), and results
    # stay row-sharded for chained evals. Dispatched by
    # parallel.shard_spmm.make_sharded_{spmm,fused_rhs}_for(cfg, ...)
    shard_spmm_mode: str = "allreduce"
    # multi-chip CLI (run.py): shard the padded edge list over this many
    # devices of a jax.sharding.Mesh (parallel.mesh.shard_graph) with node
    # states/params replicated; XLA SPMD inserts the ICI collectives.
    # 0/1 = single-device. The single-device Pallas engines (host-built
    # plans) are disabled in mesh mode — the sharded path is pure XLA ops.
    mesh_devices: int = 0
    # route the fused attention RHS's row-side gather and aggregation scatter
    # through the stripe MXU kernels (ops/pallas/stripe.py). None = AUTO:
    # ON when the backend is a TPU (every eligible config — including all
    # tuned best_params reproductions — rides the fast engine by default),
    # OFF elsewhere (CPU exercises the kernels in interpret mode only where
    # tests opt in). Explicit True/False overrides either way.
    stripe_fused: Optional[bool] = None
    # fold the GRAND-nl RHS epilogue (f = alpha·(ax − x) + per-row den
    # guard) into the fused eval kernel's final write on no-grad solves
    # (bench forwards, Trainer eval, inference) — removes the XLA-side
    # ax read + x re-read + guard pass per eval. Default ON (VERDICT r3
    # #10): measured 2.6 ms/solve faster at bench scale (probe12) and
    # verified against an on-device oracle every bench run; training
    # gradients are unaffected either way (blocks.py gates on training).
    fold_epilogue: bool = True
    # symmetric-backward engine variant: for to_undirected edge sets, each
    # edge's x[col] cotangent is computed at its REVERSE edge and scattered
    # through the row plan (fused_rhs.make_fused_ax_sym) — ONE kernel pass
    # and ONE u32 pair-packed [cap, 128] gather (lo bits ct_ax, hi bits
    # recip|ct_den), vs the column-plan form's mega kernel + packed-table
    # gather + col kernel. None = AUTO: ON whenever the plan is symmetric
    # (round-4 separable/packed rewrite measured 809 vs 878 ms/train-step
    # at arxiv bench scale; round 3's pre-separable sym form was slower
    # and defaulted OFF). Explicit False forces the column-plan backward.
    sym_backward: Optional[bool] = None
    # dtype of the per-edge payload (the x[col] gather + aggregation values):
    # bfloat16 halves the indexed-op traffic on the only random-access op in
    # the RHS (measured 13.5 -> 12.5 ms at 128 wide, larger wins when wider)
    rhs_payload_dtype: str = "float32"
    spmm_block_n: int = 1024   # 512 triggers a Mosaic compiler fault on v5e
    spmm_chunk: int = 1024
    # stripe-kernel tiling: node-block 128 + chunk 2048 measured best on v5e
    # (2.33M edges: scatter w=256 9.9 ms; chunk 512 faults Mosaic)
    stripe_block_n: int = 128
    stripe_chunk: int = 2048
    # pick the capacity-minimising chunk from the degree distribution
    # (stripe.auto_chunk); stripe_chunk is the explicit fallback
    stripe_chunk_auto: bool = True
    edge_pad_multiple: int = 512       # pad edge count to a multiple (static shapes)
    node_pad_multiple: int = 8         # pad node count to a multiple
    mesh_shape: Tuple[int, ...] = ()   # () = single chip; e.g. (8,) = 8-way edge sharding
    mesh_axis_names: Tuple[str, ...] = ("edges",)
    seed: int = 0

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def ode_hidden_dim(self) -> int:
        """Width of the ODE state: hidden (+pos enc) (+labels), doubled if augmented.

        Mirrors the runtime hidden_dim rewrites of
        reference src/base_classes.py:110-124 without mutation.
        """
        d = self.encoder_out_dim
        return 2 * d if self.augment else d

    @property
    def encoder_out_dim(self) -> int:
        d = (self.feat_hidden_dim + self.pos_enc_hidden_dim) if self.beltrami else self.hidden_dim
        if self.use_labels:
            d += self.num_classes_hint
        return d

    # number of classes is needed to compute static dims when use_labels=True;
    # set by the training harness before model init.
    num_classes_hint: int = 0

    @property
    def atol(self) -> float:
        # note: the reference couples atol to 1e-7 and rtol to 1e-9
        # (reference src/base_classes.py:56-61)
        return self.tol_scale * 1e-7

    @property
    def rtol(self) -> float:
        return self.tol_scale * 1e-9

    @property
    def atol_adjoint(self) -> float:
        return self.tol_scale_adjoint * 1e-7

    @property
    def rtol_adjoint(self) -> float:
        return self.tol_scale_adjoint * 1e-9


def _p(**kw) -> Config:
    return Config(**kw)


# Tuned reproduction configs, translated from reference src/best_params.py:1-8.
# Only fields that differ from Config defaults (and matter to this framework)
# are spelled out.
best_params = {
    "Cora": _p(
        dataset="Cora", no_early=False, add_source=True, attention_dim=128, attention_norm_idx=1,
        attention_type="scaled_dot", block="attention", data_norm="rw",
        decay=0.00507685443154266, dropout=0.046878964627763316, epoch=100,
        function="laplacian", heads=8, hidden_dim=80, input_dropout=0.5,
        lr=0.022924849756740397, max_nfe=2000, method="dopri5",
        optimizer="adamax", self_loop_weight=1.0, square_plus=True,
        time=18.294754260552843, tol_scale=821.9773048827274,
    ),
    "Citeseer": _p(
        dataset="Citeseer", no_early=False, add_source=True, attention_dim=32, attention_norm_idx=1,
        attention_type="exp_kernel", block="attention", data_norm="rw",
        decay=0.1, dropout=0.7488085003122172, epoch=250, function="laplacian",
        heads=8, hidden_dim=80, input_dropout=0.6803233752085334,
        leaky_relu_slope=0.5825086997804176, lr=0.00863585231323069,
        max_nfe=3000, method="dopri5", optimizer="adam", self_loop_weight=1.0,
        square_plus=True, time=7.874113442879092, tol_scale=2.9010446330432815,
    ),
    "Pubmed": _p(
        dataset="Pubmed", add_source=True, adjoint=True, adjoint_method="adaptive_heun",
        attention_dim=16, attention_norm_idx=0, attention_type="cosine_sim",
        block="attention", data_norm="rw", decay=0.0018236722171703636,
        dropout=0.07191100715473969, epoch=600, function="laplacian", heads=1,
        hidden_dim=128, input_dropout=0.5, lr=0.014669345840305131,
        max_nfe=5000, method="dopri5", optimizer="adamax", self_loop_weight=1.0,
        square_plus=True, time=12.942327880200853, tol_scale=1991.0688305523001,
        tol_scale_adjoint=16324.368093998313, no_early=False, earlystopxT=5.0,
    ),
    "CoauthorCS": _p(
        dataset="CoauthorCS", no_early=False, adjoint=True, adjoint_method="dopri5",
        attention_dim=8, attention_norm_idx=1, attention_type="scaled_dot",
        block="attention", data_norm="rw", decay=0.004738413087298854,
        dropout=0.6857774850321, epoch=250, function="laplacian", heads=4,
        hidden_dim=16, input_dropout=0.5275042493231822,
        leaky_relu_slope=0.7181389780997276, lr=0.0009342860080741642,
        max_nfe=3000, method="dopri5", optimizer="rmsprop", self_loop_weight=0.0,
        square_plus=True, time=3.126400580172773, tol_scale=9348.983916372074,
        tol_scale_adjoint=6599.1250595331385,
    ),
    "Computers": _p(
        dataset="Computers", no_early=False, adjoint=True, adjoint_method="dopri5",
        att_samp_pct=0.572918052062338, attention_dim=64, attention_norm_idx=0,
        attention_type="scaled_dot", block="hard_attention", data_norm="rw",
        decay=0.007674669913252157, dropout=0.08732611854459256, epoch=100,
        function="laplacian", heads=4, hidden_dim=128,
        input_dropout=0.5973137276937647, lr=0.0035304663972281548,
        max_nfe=500, method="dopri5", optimizer="adam",
        self_loop_weight=1.7138583550928912, square_plus=False,
        time=3.249016177876166, tol_scale=127.46369887079446,
        tol_scale_adjoint=443.81436775321754,
    ),
    "Photo": _p(
        dataset="Photo", no_early=False, adjoint=True, adjoint_method="rk4",
        att_samp_pct=0.9282359956104751, attention_dim=64, attention_norm_idx=0,
        attention_type="pearson", batch_norm=True, block="hard_attention",
        data_norm="rw", decay=0.004707800883497945, dropout=0.46502284638600183,
        epoch=100, function="laplacian", heads=4, hidden_dim=64,
        input_dropout=0.42903126506740247, lr=0.005560726683883279,
        max_nfe=500, method="dopri5", optimizer="adam",
        self_loop_weight=0.05783612585280118, square_plus=False,
        time=3.5824027975386623, tol_scale=2086.525473167121,
        tol_scale_adjoint=14777.606112557354,
    ),
    "ogbn-arxiv": _p(
        dataset="ogbn-arxiv", no_early=False, adjoint=True, adjoint_method="rk4",
        att_samp_pct=0.8105268910037231, attention_dim=32, attention_norm_idx=0,
        attention_type="scaled_dot", batch_norm=True, block="hard_attention",
        data_norm="rw", decay=0.0, dropout=0.11594990901233933, epoch=100,
        function="laplacian", heads=2, hidden_dim=162, input_dropout=0.0,
        label_rate=0.21964773835397075, lr=0.005451476553977102, max_nfe=500,
        method="dopri5", optimizer="rmsprop", self_loop_weight=1.0,
        square_plus=False, time=3.6760155951687636, tol_scale=11353.558848254957,
        not_lcc=False, pos_enc_type="DW64", pos_enc_hidden_dim=98,
    ),
}


# The GRAND-nl architecture that the JAX package's bench.py measures
# (build_benchmark: constant block, transformer function, rk4 with step 1.0
# to the tuned ogbn-arxiv T, hidden 128, attention_dim 32, 2 heads) at its
# precision, the bfloat16 payload and the bfloat16 fixed-grid state
# (bench.py:93-95), over the seeded random graph ``ogbn-arxiv-synthetic``.
# Not a tuned row: ``--use_best_params`` takes it for that dataset name
# only. ``GRAND_NL_BENCH.replace(**FLOAT32)`` is the same model in float32.
GRAND_NL_BENCH = Config(
    dataset="ogbn-arxiv-synthetic", block="constant", function="transformer",
    method="rk4", step_size=1.0, time=3.6760155951687636, hidden_dim=128,
    attention_dim=32, heads=2, self_loop_weight=1.0, add_source=False,
    input_dropout=0.0, dropout=0.0, max_nfe=1000, no_early=True,
    adjoint=False, edge_pad_multiple=1024, rhs_payload_dtype="bfloat16",
    dtype="bfloat16")

# the float32 payload and state, for ``Config.replace``
FLOAT32 = {"rhs_payload_dtype": "float32", "dtype": "float32"}
